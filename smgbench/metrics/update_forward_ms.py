"""Mean host ms per call of the program's `update.forward` spans in
Trainer.update (each style's train forward and its loss), over the calls
after the profiled part."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    return program_trace.ms_per_call(run, "update.forward")
