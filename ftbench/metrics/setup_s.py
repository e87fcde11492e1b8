"""setup_s: from the process's start to the first due arrival: the torch
import, the kernels built or loaded, the weights drawn, one warm prefill,
decode and publish, and the cluster's engines. Host clock."""


def read(rec):
    return rec.setup_s
