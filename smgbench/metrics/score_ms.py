"""Mean ms of the benchmark's `score` span per call (masked scene depth and
Trainer.score_scene_batch, ending in a synchronize), in a traced run: the calls after the profiled
part, when there are any."""


def read(run):
    s = run.spans.read("score") if run.spans is not None else None
    return sum(s) / len(s) * 1e3 if s else None
