"""Setting up a tool's process like a benchmark run."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def prepare():
    cache = os.path.join(ROOT, "build", "ftbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)


def free(st):
    """Drop a setup's weights from the card."""
    import gc
    st.params = None
    gc.collect()
    if st.device == "cuda":
        st.torch.cuda.empty_cache()
