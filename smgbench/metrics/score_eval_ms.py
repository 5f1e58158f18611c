"""Mean host ms of one of the program's `score_eval` spans (one eval
trunk call and its head, Trainer._score_eval), over the calls after the
profiled part. The span does not synchronize: it is the host's time."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    return program_trace.ms_per_span(run, "score_eval")
