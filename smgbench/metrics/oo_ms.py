"""Mean host ms per call of the program's `oo` spans (the OO loop,
policy/action_geom.py::oo_suction_angle), over the calls after the
profiled part."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    return program_trace.ms_per_call(run, "oo")
