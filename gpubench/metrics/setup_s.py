"""setup_s: seconds from the start of the run's process to the end of the
warm-up (imports, the program's build or load, inputs, one request of
every shape), on the host's clock."""


def read(run):
    return run.setup_s
