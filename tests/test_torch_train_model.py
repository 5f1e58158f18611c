"""Parity: the port's train-mode trunk and head (score_train) against the JAX
package's fast_trunk.score_train, float32.

A shallow DenseNet (block_config (2, 2, 2, 2)) at input 224, two scenes
with one exec mask each. The JAX function runs vmapped over batch-1 scenes,
the update's structure; the port runs the four streams through one trunk
call with per-image BatchNorm. Both lowerings of the dense layers: 'pk'
(the port's K6, plain version on the CPU; JAX's Pallas kernels in
interpret mode, which fall back to 'conv' on block 1's 56 x 56 maps) and
'conv', on the grasp style; and 'pk' on the ETS style (gs_trunk with the
tied suction head). Compared: the head outputs (3 classes) to 1e-4 of the
largest, the per-scene running statistics to STATS_TOL, and the gradients
of sum(out^2) per leaf to relative L2 < 2e-3 with a 1e-3 * gmax floor, or
WITNESS_FACTOR times the gap between JAX's own Flax autodiff of
AffordanceNet.score and its fast_trunk.score_train on the same case, where
that is larger (test_torch_parity_helpers.witness_tol).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu.models import affordance as jaff
from smg_tpu.models import fast_trunk as jft
from smg_tpu_torch import bridge
from smg_tpu_torch.models.affordance import AffordanceNet, ModelConfig, preprocess_depth

from test_torch_parity_helpers import (
    TRAIN_S,
    TRAIN_SHALLOW,
    assert_grads,
    assert_stats,
    flat_tree,
    init_flax_all,
    leaf_gaps,
    port_grads,
    rand_stats,
    shallow_train_patch,
    to_numpy_tree,
    train_images,
    witness_tol,
)

# style -> (trunk, head): the ETS style reads the tied suction head.
STYLE_PARTS = {0: ("grasp_trunk", "grasp_head"), 2: ("gs_trunk", "suction_head")}


@pytest.mark.parametrize("conv2,style", [pytest.param("pk", 0, id="pk"),
                                         pytest.param("conv", 0, id="conv"),
                                         pytest.param("pk", 2, id="pk-ets")])
def test_score_train_matches_jax(monkeypatch, conv2, style):
    shallow_train_patch(monkeypatch)
    parts = STYLE_PARTS[style]
    jm = jaff.ModelConfig(method="reactive", input_size=TRAIN_S, dtype="float32")
    net = jaff.AffordanceNet(jm)
    variables = init_flax_all(net, 128, jm.feature_hw, 1)
    params = {k: variables["params"][k] for k in parts}
    stats = rand_stats({k: variables["batch_stats"][k] for k in parts}, 1)
    cfg = ModelConfig(method="reactive", input_size=TRAIN_S, dtype="float32",
                      block_config=TRAIN_SHALLOW)
    depth, mask = train_images(1, 2)
    scene = preprocess_depth(torch.tensor(depth), cfg)
    masked = preprocess_depth(torch.tensor(depth * mask), cfg)

    def fast(sc, mk, p):
        out, mut = jft.score_train(p, stats, sc[None], mk[None, None], 3, conv2=conv2,
                                   trunk_key=parts[0], head_key=parts[1])
        return out[0, 0], mut

    def flax(sc, mk, p):
        out, _ = net.apply({"params": dict(variables["params"], **p),
                            "batch_stats": dict(variables["batch_stats"], **stats)},
                           sc[None], mk[None, None], style, True, method=net.score,
                           mutable=["batch_stats"])
        return out[0, 0], None

    def grads(one):
        def loss(p):
            outs, muts = jax.vmap(one, in_axes=(0, 0, None))(
                jnp.asarray(scene.numpy()), jnp.asarray(masked.numpy()), p)
            return jnp.sum(outs ** 2), (outs, muts)

        return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    (_, (jout, jmut)), jgrad = grads(fast)
    want_g = flat_tree(to_numpy_tree(jgrad))
    jax_gap = max(leaf_gaps(flat_tree(to_numpy_tree(grads(flax)[1])), want_g).values())

    model = AffordanceNet(cfg)
    all_stats = dict(to_numpy_tree(variables["batch_stats"]), **to_numpy_tree(stats))
    bridge.load_affordance_params(model, to_numpy_tree(variables["params"]), all_stats)
    out, new = model.score_train(scene, masked, style, conv2)
    (out ** 2).sum().backward()

    want = np.asarray(jout)
    assert out.shape == want.shape == (2, 3)
    assert float(want.std()) > 1e-3
    assert np.abs(out.detach().numpy() - want).max() <= 1e-4 * np.abs(want).max()
    got_g = {k: v for k, v in port_grads(model).items() if k[0] in parts}
    print(f"score_train {conv2} style {style}: worst gradient leaf, port "
          f"{max(leaf_gaps(got_g, want_g).values()):.3e}, JAX Flax {jax_gap:.3e}")
    assert_grads(got_g, want_g, tol=witness_tol(2e-3, jax_gap))
    got = {}
    for part in parts:
        for name, m in getattr(model, part).named_modules():
            if m in new:
                path = (part, *name.split("."))
                got[path + ("mean",)] = new[m][0].numpy()
                got[path + ("var",)] = new[m][1].numpy()
    assert_stats(got, flat_tree(to_numpy_tree(jmut)))
