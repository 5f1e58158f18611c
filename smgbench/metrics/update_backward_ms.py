"""Mean host ms per call of the program's `update.backward` spans in
Trainer.update (loss.backward()), over the calls after the profiled
part."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    return program_trace.ms_per_call(run, "update.backward")
