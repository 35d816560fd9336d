"""Share of its roofline that ``stencil_spmv_sym`` reaches: the least
time a product of the window's operator can take (``roofline.py``, from
the planes' shape) over the mean device time of the kernel's launches in
the profiler trace."""

KERNEL = "stencil_spmv_sym"


def read(run):
    if run.trace is None or run.info.get("kernel") != KERNEL:
        return None
    secs = count = 0
    for name, (s, n) in run.trace["ops"].items():
        if KERNEL in name:
            secs += s
            count += n
    if count == 0 or secs <= 0:
        return None
    return 100.0 * run.info["bound_s"] / (secs / count)
