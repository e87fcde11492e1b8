"""s1_roofline (layer: kernels, `kernels/mamba_scan`): the frozen bound
time of every S1 launch in the traced window (its bytes at 3.35 TB/s or
its operations at 67 T/s, the larger; `ftbench/yardstick/bounds.py`) over
the profiler's device time of S1's kernels (`selective_scan_fwd`), in
percent. The launches' shapes come from the benchmark's wrapper around
the port's launch function."""
from ftbench.harness.spans import patched
from ftbench.yardstick.bounds import scan_bound_s

KERNEL = "selective_scan_fwd"


def instrument(rec):
    from repro_torch.kernels.mamba_scan import ops

    def wrap(launch):
        def recorded(x, dt, B, C, A):
            if rec.t_close is None and rec.t0:
                rec.launches.setdefault("s1", []).append(
                    (*x.shape, B.shape[-1]))
            return launch(x, dt, B, C, A)
        return recorded
    return patched(ops, "selective_scan_kernel", wrap)


def read(rec):
    shapes = rec.launches.get("s1")
    if rec.device is None or not shapes:
        return None
    dev = sum(e - s for n, s, e in rec.device.events if KERNEL in n)
    if dev <= 0:
        return None
    return 100.0 * sum(scan_bound_s(*sh)[0] for sh in shapes) / dev
