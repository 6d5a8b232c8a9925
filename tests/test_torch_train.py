"""The port's training driver (``repro_torch.launch.train``) and its
checkpoints against the reference's, on the CPU, at the smoke config of
``launch/train.py``'s default arch in its native bfloat16:

* ``synthetic_batch`` equals the reference's bit for bit, every arch;
* ``train`` resumed from its own bfloat16 checkpoint gives the losses
  and final state of an uninterrupted run, bit for bit (also with
  ``compress_grads``, whose error feedback the checkpoint carries, and
  from the reference's weights passed as ``params=``);
* the reference cannot resume from its own bfloat16 checkpoint
  (``FileNotFoundError``; pinned), and the port restores it exactly and
  continues the reference's run (bfloat16, within 3e-2 as
  ``test_torch_lm_archs`` holds the forward);
* a state saved by the port has the reference's MANIFEST (keys, dtypes,
  shapes, sha1s) and the same ``.npy`` bytes;
* the CLI runs with ``--device cpu``, resumes, and without a card exits 2.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import ft as rft
from repro.configs import ARCHS, smoke_config
from repro.launch import train as rtrain
from repro.models import lm as rlm
from repro_torch import ft as tft
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import AdamWConfig, adamw_init

torch.set_num_threads(1)

ARCH = "qwen1.5-0.5b"
B, S = 2, 16
BF16_TOL = 3e-2
KW = dict(batch=B, seq=S, verbose=False)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def host_bytes(x) -> tuple:
    """(dtype name, shape, raw bytes) of a jax array or a tensor."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
        return str(t.dtype)[6:], tuple(t.shape), raw.numpy().tobytes()
    a = np.asarray(x)
    return str(a.dtype), a.shape, a.tobytes()


def assert_states_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert host_bytes(a) == host_bytes(b)


def carried_params(cfg):
    rp, _ = rlm.init_params(cfg, jax.random.PRNGKey(0))
    return params_from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), cfg,
        device="cpu")


@pytest.mark.parametrize("step", [0, 5])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_synthetic_batch_equals_reference(name, step):
    cfg = smoke_config(name)
    want = rtrain.synthetic_batch(cfg, 3, 8, step)
    got = ttrain.synthetic_batch(cfg, 3, 8, step, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "cpu"
        assert host_bytes(got[k]) == host_bytes(want[k]), k


@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's 3 steps in bf16, checkpointed at steps 2 and 3."""
    d = tmp_path_factory.mktemp("ref_train") / "ckpt"
    cfg = smoke_config(ARCH)
    state, losses = rtrain.train(cfg, steps=3, ckpt_dir=str(d), ckpt_every=2,
                                 **KW)
    assert rft.CheckpointManager(d).steps() == [2, 3]
    return cfg, d, state, losses


def test_reference_bf16_resume_fault(ref_run, tmp_path, capsys):
    """``repro.ft.CheckpointManager`` writes bf16 leaves as ``'<V2'``
    records and cannot cast them back (``No cast function available``);
    ``restore`` swallows that for every step and raises
    ``FileNotFoundError``, so the reference's training never resumes."""
    cfg, d, state, _ = ref_run
    work = tmp_path / "ckpt"
    shutil.copytree(d, work)
    with pytest.raises(FileNotFoundError, match="no usable checkpoint"):
        rtrain.train(cfg, steps=4, ckpt_dir=str(work), **KW)
    assert "No cast function available" in capsys.readouterr().out


def test_port_restores_and_continues_reference_checkpoint(ref_run, tmp_path):
    cfg, d, state, losses = ref_run
    like = {"params": carried_params(cfg)}
    like["opt"] = adamw_init(like["params"])
    got, step = tft.CheckpointManager(d).restore(like)
    assert step == 3
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert_states_equal(got, state)
    # resume the reference's run at its step-2 checkpoint
    work = tmp_path / "ckpt"
    shutil.copytree(d, work)
    shutil.rmtree(work / "step_00000003")
    _, resumed = ttrain.train(cfg, steps=3, ckpt_dir=str(work),
                              device="cpu", **KW)
    assert len(resumed) == 1
    assert abs(resumed[0] - losses[2]) <= BF16_TOL * (1 + abs(losses[2]))


def test_port_manifest_equals_reference(ref_run, tmp_path):
    cfg, d, state, _ = ref_run
    tstate = jax.tree.map(
        lambda a: torch.from_numpy(np.array(a, np.float32)).to(
            {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "int32": torch.int32}[str(a.dtype)]), state)
    out = tft.CheckpointManager(tmp_path).save(3, tstate)
    ref = d / "step_00000003"
    manifest = json.loads((out / "MANIFEST.json").read_text())
    assert manifest == json.loads((ref / "MANIFEST.json").read_text())
    assert "bfloat16" in {m["dtype"] for m in manifest["leaves"].values()}
    for meta in manifest["leaves"].values():
        assert (out / meta["file"]).read_bytes() == (
            ref / meta["file"]).read_bytes()


@pytest.mark.parametrize("variant", ["default", "compress_grads",
                                     "reference_params"])
def test_train_resumes_bit_for_bit(variant, tmp_path):
    cfg = smoke_config(ARCH)
    kw = dict(KW, device="cpu")
    if variant == "compress_grads":
        kw["opt"] = AdamWConfig(compress_grads=True)

    def params():
        return carried_params(cfg) if variant == "reference_params" else None
    first = ttrain.train(cfg, steps=2, ckpt_dir=str(tmp_path / "a"),
                         params=params(), **kw)[1]
    state, resumed = ttrain.train(cfg, steps=3, ckpt_dir=str(tmp_path / "a"),
                                  params=params(), **kw)
    wstate, whole = ttrain.train(cfg, steps=3, ckpt_dir=str(tmp_path / "b"),
                                 params=params(), **kw)
    assert len(first) == 2 and len(resumed) == 1
    assert first + resumed == whole
    assert all(np.isfinite(whole))
    assert_states_equal(state, wstate)
    assert ("error_fb" in state) == (variant == "compress_grads")
    assert state["params"]["embed"].dtype == torch.bfloat16


def test_checkpoint_tensor_leaves_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    state = {"w": w.to(torch.bfloat16), "m": w.clone(),
             "step": torch.tensor(7, dtype=torch.int32),
             "q": torch.arange(-3, 3, dtype=torch.int8),
             "host": np.arange(3, dtype=np.int64)}
    mgr = tft.CheckpointManager(tmp_path)
    out = mgr.save(1, state)
    manifest = json.loads((out / "MANIFEST.json").read_text())
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    with open(out / manifest["leaves"]["w"]["file"], "rb") as f:
        np.lib.format.read_magic(f)
        shape, _, dtype = np.lib.format.read_array_header_1_0(f)
    assert shape == (4, 3) and dtype == np.dtype("V2")
    like = {"w": torch.zeros(4, 3, dtype=torch.bfloat16),
            "m": torch.zeros(4, 3), "step": torch.tensor(0, dtype=torch.int32),
            "q": torch.zeros(6, dtype=torch.int8),
            "host": np.zeros(3, np.int64)}
    got, step = mgr.restore(like)
    assert step == 1 and isinstance(got["host"], np.ndarray)
    for k in state:
        assert host_bytes(got[k]) == host_bytes(state[k])
    # a float32 like turns a bf16 leaf into its float32 values
    got, _ = mgr.restore(dict(like, w=torch.zeros(4, 3)))
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], state["w"].float())


def test_train_cli_on_the_cpu(tmp_path, capsys):
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    assert ttrain.main(argv + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "done in" in out
    assert ttrain.main(argv + ["--steps", "3"]) == 0
    assert "[train] resumed from step 2" in capsys.readouterr().out
    assert tft.CheckpointManager(tmp_path).steps() == [2, 3]


def test_train_without_cuda_raises(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(ARCH)
    assert ttrain.main(["--smoke", "--steps", "1",
                        "--ckpt-dir", str(tmp_path)]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(cfg, steps=1, ckpt_dir=str(tmp_path), **KW)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.synthetic_batch(cfg, 1, 4, 0)
    assert not list(tmp_path.iterdir())
