"""Mean ms of the benchmark's `policy` span per call (arbitrate.select_action
and smg_env.compute_geometry, ending in a synchronize), in a traced run: the calls after the profiled
part, when there are any."""


def read(run):
    s = run.spans.read("policy") if run.spans is not None else None
    return sum(s) / len(s) * 1e3 if s else None
