"""Process start to the window's start: import, CUDA context, kernel
library and native core (built on a first run), input, containers, the
warm-up."""


def read(run):
    return run.setup_s
