"""Device idle inside the profiled part while the host is inside one of
the program's `score_eval` spans (Trainer._score_eval), on the realtime
clock that the trace counts from, in ms per profiled call."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    return program_trace.idle_ms_per_call(run, "score_eval")
