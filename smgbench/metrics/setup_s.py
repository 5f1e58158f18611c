"""Seconds from the start of the benchmark's process to the end of the
warm-up calls: imports, the program built, the kernels loaded or built,
weights and traffic made, every shape warmed up."""


def read(run):
    return run.setup_s
