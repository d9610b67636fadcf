"""Process start to the window's first event: imports, the CUDA context,
the kernel's build or cache, the cluster, the warm-up cycles."""


def read(m):
    return m["setup_s"]
