"""Set-up seconds: process start to the first timed request (import,
kernel-library load, space, set-up assembly, warm-up), host clock."""


def read(run):
    return run.setup_s
