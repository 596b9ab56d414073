"""setup_s: seconds from the process's start to the first timed unit
(imports, CUDA context, inputs made from the seed, warm-up)."""


def read(run):
    return run.setup_s
