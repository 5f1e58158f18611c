"""The program's `trunk_images_useful` over its `trunk_images` in the
window's calls, in %. Trainer._score_eval counts every image sent to an
eval trunk, from the shapes of the tensors it gets; Trainer.score_scene
counts those that the valid objects and pairs need, as
smgbench/bounds.py::decision_flops counts them."""

from smgbench import program_trace

install = program_trace.install


def read(run):
    useful = program_trace.counted(run, "trunk_images_useful")
    computed = program_trace.counted(run, "trunk_images")
    return 100.0 * useful / computed if useful is not None and computed else None
