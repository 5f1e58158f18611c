"""The port's experiment runner (cli/main.py) against the JAX package's, on
the CPU.

- Flags: the reference command lines give the same info/config.json keys
  and values under both packages' parse_args, apart from the fields that
  only one side has (listed below); --pretrained_trunks and
  --data_parallel parse, a --data_parallel that does not divide the batch
  and a heightmap resolution other than the reference's stop with
  SystemExit, and a mesh directory without .obj meshes stops.
- Log rows: one numpy StepMetrics through JAX's log_step_metrics and the
  port's (directly, and through fetch_metrics from tensors) gives
  byte-identical .log.txt files, across a step with finished episodes and
  a nonzero episode_base; the .bin mirror reads back the text rows, also
  after a resumed logger reopens it.
- Camera: Camera.overhead() and reference_overhead() equal JAX's to
  float32 rounding.
- Perspective render: render_rgbd against JAX's on the same objects at a
  reduced frame (its height / width arguments, intrinsics scaled with
  them): depth within 1e-5 m, colour exact, except on silhouette pixels
  (counted, at most SILHOUETTE_BOUND of the frame).
- End to end: run(cfg) with one-layer dense blocks, B = 2 and 3-step
  primitive phases trains 2 iterations into the tree that
  scripts/analyze_results.py::summarize reads, a --continue_logging run
  resumes at iteration 3, a testing run loads the snapshot; cli.smoke runs
  its cycle; cli.pretrain_trunks writes a checkpoint that
  --pretrained_trunks puts into the three trunks of both nets; with
  --data_parallel 2 over two gloo ranks (as under torchrun) rank 0 writes
  the run tree of the one-process run: the same actions and rewards, the
  loss and labels to relative 1e-5 (tests/test_torch_parallel.py holds
  the sharded step itself), and --data_parallel outside torchrun stops.
"""

import copy
import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smg_tpu_torch.cli import decision_parity as dp
from smg_tpu_torch.cli import main as cli
from smg_tpu_torch.cli import smoke
from smg_tpu_torch.core import camera as cam
from smg_tpu_torch.envs import smg_env as env
from smg_tpu_torch.envs.primitives import PrimitiveParams
from smg_tpu_torch.models.affordance import AffordanceNet, ModelConfig
from smg_tpu_torch.physics import scene as scene_mod
from smg_tpu_torch.render import persp
from smg_tpu_torch.train import checkpoints
from smg_tpu_torch.train.loop import StepMetrics
from smg_tpu_torch.train.trainer import TrainConfig, Trainer
from smg_tpu_torch.utils import config as cfg_mod
from smg_tpu_torch.utils import native
from smg_tpu_torch.utils.logger import LOG_NAMES, Logger

torch.set_num_threads(1)  # as test_torch_parity_helpers.py: one thread per xdist worker

REPO = Path(__file__).resolve().parent.parent

REFERENCE_CMDS = [
    "--is_sim --method reactive --is_pe --is_oo --explore_rate_decay",
    "--is_sim --method reinforcement --is_pe --is_oo",
    "--is_sim --method reactive --is_ets --is_pe --is_oo",
    "--is_sim --method reinforcement --is_ets --is_pe --is_oo",
    "--is_sim --method reinforcement --is_ets --is_pe --is_oo --is_cluttered",
    "--is_testing --load_snapshot --snapshot_file /tmp/x",
    "--is_sim --method reinforcement --is_ets --is_pe --is_oo --batch_size 32 "
    "--imagery_every 0 --trunk densenet121 --input_size 224 --training_episode 800",
    "--batch_size 64 --input_size 640 --seed 7 --step 30 --target_update_freq 5 "
    "--future_reward_discount 0.7 --continue_logging --logging_directory x",
    "--is_sim --method reinforcement --is_pe --is_oo --batch_size 32 --trunk tiny "
    "--segmentation learned --segmenter_checkpoint s --training_episode 160",
    "--is_sim --method reinforcement --is_ets --is_pe --is_oo --batch_size 32 "
    "--data_parallel 4 --pretrained_trunks logs/trunk_pretrain",
]
# info/config.json fields that only one package has.
JAX_ONLY = {("train", "fast_train"), ("train", "unroll_styles")}
PORT_ONLY = {("train", "model", "block_config"), ("device",)}

SILHOUETTE_BOUND = 2e-3
BLOCKS = (1, 1, 1, 1)
SHORT = PrimitiveParams(steps_move_above=3, steps_preclose=3, steps_descend=3,
                        steps_squeeze=3, steps_lift=3, steps_pad_align=3,
                        steps_finish=3)


def _flat(d, prefix=()):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = list(v) if isinstance(v, tuple) else v
    return out


# ---------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cmd", REFERENCE_CMDS)
def test_config_dict_matches_jax(cmd):
    from smg_tpu.utils import config as jcfg

    want = _flat(jcfg.parse_args(cmd.split()).to_dict())
    got = _flat(cfg_mod.parse_args(cmd.split()).to_dict())
    assert JAX_ONLY <= want.keys() and PORT_ONLY <= got.keys()
    assert want.keys() - JAX_ONLY == got.keys() - PORT_ONLY
    for k in want.keys() - JAX_ONLY:
        assert got[k] == want[k], k


def test_device_flag():
    assert cfg_mod.parse_args([]).device == "cuda"
    assert cfg_mod.parse_args(["--cpu"]).device == "cpu"
    assert cli.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.resolve_device("cuda")


@pytest.mark.parametrize("argv,item", [
    ("--heightmap_resolution 0.004", "heightmap_resolution"),
    ("--batch_size 8 --data_parallel 3", "divisible"),
])
def test_unported_flags_stop(argv, item):
    with pytest.raises(SystemExit, match=item):
        cfg_mod.parse_args(argv.split())


@pytest.mark.parametrize("argv,field,value", [
    ("--batch_size 8 --data_parallel 2", "data_parallel", 2),
    ("--pretrained_trunks p.pt", "pretrained_trunks", "p.pt"),
])
def test_ported_flags_parse(argv, field, value):
    assert getattr(cfg_mod.parse_args(argv.split()), field) == value


def test_mesh_dir_stops(tmp_path):
    """A mesh directory without .obj meshes stops the parse (one with them
    parses: tests/test_torch_meshes.py)."""
    (tmp_path / "enveloping").mkdir()
    with pytest.raises(SystemExit, match="no .obj meshes"):
        cfg_mod.parse_args(["--obj_mesh_dir", str(tmp_path)])


@pytest.mark.parametrize("argv,field,value", [
    ("--trunk tiny", ("train", "model", "trunk"), "tiny"),
    ("--segmentation learned --segmenter_checkpoint s", ("env", "segmentation"), "learned"),
])
def test_ported_nested_flags_parse(argv, field, value):
    cfg = cfg_mod.parse_args(argv.split())
    assert _flat(cfg.to_dict())[field] == value


# ---------------------------------------------------------------------------
# Log rows
# ---------------------------------------------------------------------------


def _metrics_np(rng, B, done):
    m = {
        "loss": np.float32(rng.rand()),
        "reward": rng.choice([0.0, 0.5, 1.0, 2.5], B).astype(np.float32),
        "label_value": rng.randn(B).astype(np.float32),
        "predicted_value": rng.randn(B).astype(np.float32),
        "action": rng.randint(0, 3, B).astype(np.int32),
        "explored": rng.rand(B) < 0.5,
        "best_pix": rng.randint(0, 224, (B, 6)).astype(np.int32),
        "objects_number": rng.randint(0, 11, B).astype(np.int32),
        "episodes_done": np.isin(np.arange(B), done),
        "episode_iter": rng.randint(1, 21, B).astype(np.int32),
        "episode_succ": rng.randint(0, 10, B).astype(np.int32),
        "grasp_success": (rng.rand(B) < 0.5).astype(np.float32),
        "suction_success": (rng.rand(B) < 0.5).astype(np.float32),
        "gs_success": rng.choice([0.0, 0.5, 2.5], B).astype(np.float32),
        "color_hm0": np.zeros((224, 224, 3), np.float32),
        "depth_hm0": np.zeros((224, 224), np.float32),
        "exec_mask0": np.zeros((224, 224), bool),
        "seg_masks0": np.zeros((12, 224, 224), bool),
        "seg_boxes0": np.zeros((12, 2, 2), np.float32),
        "seg_valid0": np.zeros(12, bool),
    }
    return m


def _log_bytes(directory: str) -> dict:
    out = {}
    for name in LOG_NAMES:
        p = os.path.join(directory, f"{name}.log.txt")
        out[name] = open(p, "rb").read() if os.path.exists(p) else b""
    return out


def test_log_rows_byte_identical(tmp_path):
    from smg_tpu.cli import main as jmain
    from smg_tpu.train import loop as jloop
    from smg_tpu.utils.logger import Logger as JLogger

    rng = np.random.RandomState(0)
    B = 5
    steps = [_metrics_np(rng, B, []), _metrics_np(rng, B, [1, 3, 4])]
    jl = JLogger(False, str(tmp_path / "jax"))
    direct = Logger(False, str(tmp_path / "port"))
    fetched = Logger(False, str(tmp_path / "fetched"))
    bases = {"jax": 7, "direct": 7, "fetched": 7}
    for it, m in enumerate(steps, start=1):
        bases["jax"] += jmain.log_step_metrics(
            jl, jloop.StepMetrics(**m), it, bases["jax"])
        bases["direct"] += cli.log_step_metrics(
            direct, jloop.StepMetrics(**m), it, bases["direct"])
        tm = StepMetrics(**{k: torch.as_tensor(np.asarray(v)) for k, v in m.items()})
        host = cli.fetch_metrics(tm, torch.tensor([2, 0, 1, 0, 3], dtype=torch.int32))
        assert host.episodes == 6
        bases["fetched"] += cli.log_step_metrics(fetched, host, it, bases["fetched"])
    assert bases == {"jax": 10, "direct": 10, "fetched": 10}
    for lg in (jl, direct, fetched):
        lg.close()
    want = _log_bytes(jl.transitions_directory)
    assert all(want.values()), "every log has rows after the second step"
    assert want["episode_success"].startswith(b"7.0000")
    for lg in (direct, fetched):
        assert _log_bytes(lg.transitions_directory) == want


def test_binary_mirror_and_resume(tmp_path):
    if native.load_library() is None:
        pytest.skip("the native library does not build here")
    lg = Logger(False, str(tmp_path))
    lg.write_to_log("training_loss", [[1, 0.25], [2, 0.125]])
    lg.close()
    again = Logger(True, lg.base_directory)
    again.write_to_log("training_loss", [[3, 0.5]])
    text = again.read_log("training_loss")
    again.close()
    assert text.tolist() == [[1, 0.25], [2, 0.125], [3, 0.5]]
    back = native.read_binary_log(os.path.join(lg.transitions_directory,
                                               "training_loss.log.bin"))
    np.testing.assert_array_equal(np.stack(back), text.astype(np.float32))
    assert again.read_log("clearance").shape == (0, 0)


# ---------------------------------------------------------------------------
# Camera and the perspective render
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["overhead", "reference_overhead"])
def test_camera_matches_jax(which):
    from smg_tpu.core import camera as jcam

    want = getattr(jcam.Camera, which)()
    got = getattr(cam.Camera, which)()
    np.testing.assert_array_equal(got.intrinsics.numpy(), np.asarray(want.intrinsics))
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), rtol=0,
                               atol=float(np.finfo(np.float32).eps))
    assert got.pose.dtype == torch.float32


def _silhouette(depth_a, depth_b):
    """Pixels within 2 px of a depth step over 1 mm in either frame."""
    from scipy.ndimage import binary_dilation

    def steps(d):
        e = np.zeros(d.shape, bool)
        e[:, 1:] |= np.abs(np.diff(d, axis=1)) > 1e-3
        e[1:, :] |= np.abs(np.diff(d, axis=0)) > 1e-3
        return e
    return binary_dilation(steps(depth_a) | steps(depth_b), np.ones((5, 5), bool))


@pytest.mark.parametrize("seed", [0, 1])
def test_render_rgbd_matches_jax(seed):
    from smg_tpu.core import camera as jcam
    from smg_tpu.physics import state as jstate
    from smg_tpu.render import persp as jpersp

    scenes = scene_mod.reset_scene(torch.Generator().manual_seed(seed), 1, "cpu",
                                   is_cluttered=True, settle_steps=20)
    obj = scenes.objects.map(lambda x: x[0])
    H, W, s = 120, 160, 0.25      # a quarter of the 480 x 640 frame
    K = cam.DEFAULT_INTRINSICS * np.array([[s], [s], [1.0]], np.float32)
    pose = cam.Camera.overhead().pose
    color, depth = persp.render_rgbd(obj, cam.Camera(torch.as_tensor(K), pose), H, W)
    jobj = jstate.Objects(**{f.name: jnp.asarray(getattr(obj, f.name).numpy())
                             for f in dataclasses.fields(obj)})
    jc = jcam.Camera(intrinsics=jnp.asarray(K), pose=jnp.asarray(pose.numpy()))
    wc, wd = jax.jit(lambda o: jpersp.render_rgbd(o, jc, H, W))(jobj)
    wc, wd = np.asarray(wc), np.asarray(wd)
    color, depth = color.numpy(), depth.numpy()
    assert depth.shape == (H, W) and color.shape == (H, W, 3)
    assert (depth < 0.5).sum() > 100, "objects in view"
    edge = _silhouette(depth, wd)
    off_d = np.abs(depth - wd) > 1e-5
    off_c = np.abs(color - wc).max(-1) > 0
    assert not ((off_d | off_c) & ~edge).any(), "differs off the silhouettes"
    assert (off_d | off_c).mean() <= SILHOUETTE_BOUND, (off_d | off_c).sum()


# ---------------------------------------------------------------------------
# The runner end to end, the smoke test, snapshots at another input size
# ---------------------------------------------------------------------------


def _small(cfg):
    model = dataclasses.replace(cfg.train.model, block_config=BLOCKS)
    e = dataclasses.replace(cfg.env, settle_steps=5)
    loop = dataclasses.replace(cfg.loop, env=e, reset_settle_steps=3, primitive=SHORT)
    return dataclasses.replace(cfg, env=e, loop=loop,
                               train=dataclasses.replace(cfg.train, model=model))


def _analyze():
    spec = importlib.util.spec_from_file_location(
        "analyze_results", REPO / "scripts" / "analyze_results.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_run_train_resume_test(tmp_path, capsys):
    flags = ["--cpu", "--is_sim", "--method", "reinforcement", "--is_pe", "--is_oo",
             "--batch_size", "2"]
    out = cli.run(_small(cfg_mod.parse_args(
        flags + ["--max_iterations", "2", "--imagery_every", "2",
                 "--logging_directory", str(tmp_path / "train")])))
    run_dir = Path(out["run_dir"])
    assert out["iterations"] == 2
    cfg_json = (run_dir / "info" / "config.json").read_text()
    assert '"batch_size": 2' in cfg_json and '"device": "cpu"' in cfg_json
    for name in LOG_NAMES:
        assert (run_dir / "transitions" / f"{name}.log.txt").exists(), name
    assert sorted(os.listdir(run_dir / "models" / "ckpt")) == ["2.pt"]
    assert (run_dir / "models" / "snapshot").is_file()
    assert np.load(run_dir / "data" / "color-images" / "000002.0.color.npy").shape == (480, 640, 3)
    for p in ("data/color-heightmaps/000002.0.color.npy",
              "data/depth-heightmaps/000002.0.depth.npy",
              "visualizations/000002.action.npy"):
        assert (run_dir / p).is_file(), p
    summary = _analyze().summarize(str(run_dir))
    assert summary["batch"] == 2 and summary["transitions"] == 4
    assert "success_rate" in summary and "final_loss" in summary
    episodes = np.loadtxt(run_dir / "transitions" / "episode_success.log.txt", ndmin=2)

    out = cli.run(_small(cfg_mod.parse_args(
        flags + ["--continue_logging", "--logging_directory", str(run_dir),
                 "--max_iterations", "3", "--imagery_every", "0"])))
    assert out["iterations"] == 3
    assert "Resumed trainer state from checkpoint step 2 (iteration 2)" in capsys.readouterr().out
    loss = np.loadtxt(run_dir / "transitions" / "training_loss.log.txt", ndmin=2)
    assert loss[:, 0].tolist() == [1.0, 2.0, 3.0]
    after = np.loadtxt(run_dir / "transitions" / "episode_success.log.txt", ndmin=2)
    assert after[:, 0].tolist() == list(range(after.shape[0]))
    assert after.shape[0] >= episodes.shape[0]
    assert sorted(os.listdir(run_dir / "models" / "ckpt")) == ["2.pt", "3.pt"]

    out = cli.run(_small(cfg_mod.parse_args(
        flags + ["--is_testing", "--load_snapshot", "--snapshot_file",
                 str(run_dir / "models" / "snapshot"), "--obj_mesh_dir", "datasets/testing",
                 "--max_iterations", "1", "--imagery_every", "0",
                 "--logging_directory", str(tmp_path / "test")])))
    assert "Pre-trained model snapshot loaded from" in capsys.readouterr().out
    test_dir = Path(out["run_dir"])
    assert not (test_dir / "models" / "snapshot").exists()
    assert _analyze().summarize(str(test_dir))["transitions"] == 2


def test_pretrained_trunks_run(tmp_path, capsys):
    """cli.pretrain_trunks (tiny trunk, 2 steps) writes a checkpoint;
    --pretrained_trunks puts its trunk into the three trunks of the online
    and the target net, whose heads keep their init, and trains on."""
    from smg_tpu_torch.cli import pretrain_trunks

    ckpt = str(tmp_path / "trunk.pt")
    res = pretrain_trunks.train(2, 2, ckpt, trunk="tiny", log_every=1, device="cpu")
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
    assert "pretrain step 2/2 | recon loss" in capsys.readouterr().out
    flags = ["--cpu", "--method", "reinforcement", "--is_pe", "--is_oo", "--batch_size", "2",
             "--trunk", "tiny", "--pretrained_trunks", ckpt, "--imagery_every", "0",
             "--logging_directory", str(tmp_path / "run")]
    cfg = _small(cfg_mod.parse_args(flags + ["--max_iterations", "1"]))
    trainer = Trainer(cfg.train, device="cpu")
    from smg_tpu_torch.train.loop import init_loop

    init_loop(cfg.seed, trainer, cfg.loop)
    head = {k: v.clone() for k, v in trainer.model.grasp_head.state_dict().items()}
    checkpoints.load_pretrained(trainer, ckpt)
    want = {k[len("trunk."):]: v for k, v in checkpoints.load_params(ckpt).items()
            if k.startswith("trunk.")}
    for net in (trainer.model, trainer.target):
        for part in ("grasp_trunk", "suction_trunk", "gs_trunk"):
            for k, v in getattr(net, part).state_dict().items():
                assert torch.equal(v, want[k]), (part, k)
        for k, v in net.grasp_head.state_dict().items():
            assert torch.equal(v, head[k]), k
    out = cli.run(cfg)
    assert out["iterations"] == 1
    assert f"pretrained trunks loaded from: {ckpt}" in capsys.readouterr().out


def test_pretrained_trunks_resume_order(tmp_path, monkeypatch, capsys):
    """--continue_logging with --pretrained_trunks takes the JAX package's
    order (smg_tpu/cli/main.py:174-228): the checkpoint is restored first,
    then the pretrained trunk goes into the three trunks of the online net
    and the target becomes its copy. So at the resumed run's first step the
    trunks of both nets are the pretrained one, the heads the checkpoint's
    online heads, the iteration the checkpoint's, and Adam's state the
    checkpoint's (its moments keyed by the same parameters)."""
    from smg_tpu_torch.cli import pretrain_trunks

    trunk_ckpt = str(tmp_path / "trunk.pt")
    pretrain_trunks.train(2, 2, trunk_ckpt, trunk="tiny", device="cpu")
    run = str(tmp_path / "run")
    flags = ["--cpu", "--method", "reinforcement", "--is_pe", "--is_oo", "--batch_size", "2",
             "--trunk", "tiny", "--imagery_every", "0", "--logging_directory", run]
    cli.run(_small(cfg_mod.parse_args(flags + ["--max_iterations", "2"])))
    (run_dir,) = Path(run).iterdir()
    saved = torch.load(run_dir / "models" / "ckpt" / "2.pt", weights_only=True)
    pretrained = {k[len("trunk."):]: v for k, v in checkpoints.load_params(trunk_ckpt).items()
                  if k.startswith("trunk.")}

    seen = {}
    step = cli.train_step

    def first_step(trainer, loop_cfg, state):
        if not seen:
            seen.update(iteration=state.trainer.iteration,
                        model=copy_state(trainer.model), target=copy_state(trainer.target),
                        names=[n for n, _ in trainer.model.named_parameters()],
                        opt=copy.deepcopy(trainer.opt.state_dict()))
        return step(trainer, loop_cfg, state)

    copy_state = lambda m: {k: v.clone() for k, v in m.state_dict().items()}  # noqa: E731
    monkeypatch.setattr(cli, "train_step", first_step)
    out = cli.run(_small(cfg_mod.parse_args(
        flags[:-1] + [str(run_dir), "--continue_logging", "--pretrained_trunks", trunk_ckpt,
                      "--max_iterations", "3"])))
    text = capsys.readouterr().out
    assert "Resumed trainer state from checkpoint step 2" in text
    assert f"pretrained trunks loaded from: {trunk_ckpt}" in text
    assert out["iterations"] == 3 and seen["iteration"] == 2 == saved["iteration"]
    for net in ("model", "target"):
        for name, v in seen[net].items():
            part, key = name.split(".", 1)
            if part.endswith("_trunk"):
                assert torch.equal(v, pretrained[key]), (net, name)
            else:
                assert torch.equal(v, saved["model"][name]), (net, name)
    assert any(not torch.equal(saved["model"][k], v) for k, v in seen["model"].items()
               if k.split(".", 1)[0].endswith("_trunk"))
    want_opt = saved["optimizer"]["state"]
    assert seen["opt"]["state"].keys() == want_opt.keys()
    for i, name in enumerate(seen["names"]):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(seen["opt"]["state"][i][k], want_opt[i][k]), (name, k)
    assert any(want_opt[i]["exp_avg"].abs().sum() > 0 for i, name in enumerate(seen["names"])
               if "_head." in name)


def test_data_parallel_run(tmp_path):
    from smg_tpu_torch.parallel import dryrun

    import test_torch_parallel_workers as workers

    flags = ["--cpu", "--is_sim", "--method", "reinforcement", "--is_pe", "--is_oo",
             "--batch_size", "2", "--max_iterations", "2", "--imagery_every", "0"]
    with pytest.raises(SystemExit, match="torchrun"):
        cli.run(cfg_mod.parse_args(flags + ["--data_parallel", "2"]))
    one = Path(cli.run(workers.small_cli_config(
        flags + ["--logging_directory", str(tmp_path / "one")]))["run_dir"])
    dryrun.spawn_ranks(workers.cli_worker, 2,
                       flags + ["--data_parallel", "2", "--logging_directory",
                                str(tmp_path / "two")],
                       init_method=f"file://{tmp_path / 'rendezvous'}")
    (two,) = (tmp_path / "two").iterdir()
    assert sorted(os.listdir(two / "models" / "ckpt")) == ["2.pt"]
    assert (two / "models" / "snapshot").is_file()
    for name in LOG_NAMES:
        a = np.loadtxt(one / "transitions" / f"{name}.log.txt", ndmin=2)
        b = np.loadtxt(two / "transitions" / f"{name}.log.txt", ndmin=2)
        assert a.shape == b.shape, name
        if name in ("training_loss", "label-value", "predicted-value"):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_smoke_cycle(capsys):
    trainer = Trainer(TrainConfig(model=ModelConfig(input_size=224, block_config=BLOCKS)),
                      device="cpu")
    res = smoke.smoke(trainer, 2, 0, cfg=env.EnvConfig(is_pe=True, is_oo=True,
                                                       settle_steps=5), primitive=SHORT)
    assert len(res) == 2
    assert all(name in smoke.ACTION_NAMES.values() and r in (0.0, 1.0) for name, r in res)
    assert "scene objects in view" in capsys.readouterr().out


def test_snapshot_carried_to_640(tmp_path):
    src = AffordanceNet(ModelConfig(input_size=224, block_config=BLOCKS))
    path = str(tmp_path / "snapshot")
    checkpoints.save_params(path, src)
    same = dp.make_model(224, device="cpu", block_config=BLOCKS, snapshot=path)
    for name, t in same.state_dict().items():
        assert torch.equal(t, src.state_dict()[name]), name
    big = dp.make_model(640, device="cpu", block_config=BLOCKS, snapshot=path)
    w, w2 = src.grasp_head.conv1.weight, big.grasp_head.conv1.weight
    assert w2.shape[-2:] == (20, 20)
    assert torch.equal(w2[..., 3:17:2, 3:17:2] * 4.0, w)
    assert not w2[..., :3, :].any() and not w2[..., 17:, :].any()
    torch.testing.assert_close(w2.sum(dim=(-2, -1)), w.sum(dim=(-2, -1)))
    assert torch.equal(big.grasp_trunk.conv0.weight, src.grasp_trunk.conv0.weight)
