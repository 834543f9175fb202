"""The Siren family: the SP-NeRF field of the flagship (a Siren trunk over
a positional mapping and a semantic embedding, with sigma, albedo, sun,
sky and semantic heads), at any width.

An adapter over the benchmark's frozen Siren modules, which it leaves as
they are: `traffic.make_weights` lays out its weights, `program` drives the
port's `Trainer` and whole-image renderer, `reference` is its plain
reference, `flops` counts its operations. What a family gives is listed in
benchmark/README.md ("A model family").
"""

from benchmark import flops, program, reference, traffic

LOWER = reference.LOWER  # the control's precision, by the stated one

make_weights = traffic.make_weights
TrainProgram = program.TrainProgram
RenderProgram = program.RenderProgram
reference_train = reference.train
reference_eval_rows = reference.eval_rows
train_flops_per_ray = flops.train_flops_per_ray
render_flops_per_ray = flops.render_flops_per_ray
count_points = program.count_field_points
field_call_work = flops.field_call_work


def label_classes(model):
    """The semantic classes a scene's and a view's labels are drawn from."""
    return model["num_sem_classes"]
