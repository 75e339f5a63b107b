"""setup_s: seconds from the start of the run's process to the first timed
call: imports, the kernels' build or load, the inputs made on the
device, the entry's set-up and its warm-up on every batch of the pool."""


def read(run):
    return run.setup_s
