"""Mean host ms per call of the program's `update.adam` spans in
Trainer.update (the zero gradients of unused leaves and Adam's step),
over the calls after the profiled part."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    return program_trace.ms_per_call(run, "update.adam")
