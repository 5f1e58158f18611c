"""Mean host ms per call of the program's `update.bn_stats` spans in
Trainer.update (the BatchNorm running statistics' update), over the
calls after the profiled part."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    return program_trace.ms_per_call(run, "update.bn_stats")
