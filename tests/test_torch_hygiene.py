"""The port stands alone and never hides the device:

* importing every ``repro_torch`` module and ``chip_smoke.py`` loads no
  JAX and nothing of the ``repro`` package;
* without a CUDA device the entry points (``Aligner``, ``align_pairs``,
  ``cli mem``, single-end and paired, ``serve.AlignmentServer``, ``cli
  serve``, and the LM's ``init_params``, ``init_cache``,
  ``LanguageModel``, ``python -m repro_torch.launch.serve`` and the dry
  run's ``run_smoke``, ``lower_cell`` and ``python -m
  repro_torch.launch.dryrun``) raise or exit non-zero at their default
  device instead of running on the CPU;
* a kernel wrapper given a tensor on any device other than the CPU or a
  CUDA device raises instead of running its plain version;
* the layers import one way (read from the sources, nothing imported):
  ``core`` and ``pe`` defer no import, ``core`` imports nothing of
  ``pe``, ``api`` or ``kernels.engine``, and each kernel wrapper package
  imports no driver, no engine and no other wrapper.
"""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api, cli
from repro_torch.core import fmindex as tfm
from repro_torch.core.bsw import BSWParams
from repro_torch.data import (make_reference, write_fasta, write_fastq,
                              write_fastq_pair)
from repro_torch.kernels import launch_counts
from repro_torch.kernels.bsw import bsw_call, bsw_extend_kernel
from repro_torch.kernels.fmocc import ext_round, occ

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_imports_pull_in_no_jax_and_no_reference():
    code = f"""
import importlib, json, runpy, sys
sys.path.insert(0, {str(ROOT / "src")!r})
for m in {port_modules()!r}:
    importlib.import_module(m)
runpy.run_path({str(ROOT / "chip_smoke.py")!r}, run_name="chip_smoke")
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(json.dumps(bad))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(port_modules()) > 20


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("hygiene")
    ref = make_reference(3000, seed=1)
    fa, fq = str(d / "ref.fa"), str(d / "r.fq")
    write_fasta(fa, ref)
    write_fastq(fq, np.tile(ref[100:201], (2, 1)))
    fq1, fq2 = str(d / "r1.fq"), str(d / "r2.fq")
    write_fastq_pair(fq1, fq2, np.tile(ref[100:201], (2, 1)),
                     np.tile(ref[400:501], (2, 1)))
    return tfm.build_index(ref), fa, fq, d, fq1, fq2


def test_aligner_without_cuda_raises(no_cuda, tiny):
    idx = tiny[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Aligner(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Aligner(idx, device="cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        api.Aligner(idx, device="meta")
    # asking for the CPU explicitly is the one way to run there
    assert api.Aligner(idx, device="cpu").options.device == "cpu"


def test_align_pairs_without_cuda_raises(no_cuda, tiny):
    idx = tiny[0]
    r = np.zeros((2, 50), np.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.Aligner(idx).align_pairs(r, r)
    got = api.Aligner(idx, device="cpu").align_pairs(r, r)
    assert got.paired and len(got.sam()) == 4


def test_cli_paired_mem_without_cuda_exits_nonzero(no_cuda, tiny, capsys):
    _, fa, _, d, fq1, fq2 = tiny
    out = d / "pe.sam"
    assert cli.main(["mem", fa, fq1, fq2, "-o", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
    assert cli.main(["mem", fa, fq1, fq2, "-o", str(out),
                     "--device", "cpu"]) == 0
    assert len([ln for ln in out.read_text().splitlines()
                if not ln.startswith("@")]) == 4


def test_cli_mem_without_cuda_exits_nonzero(no_cuda, tiny, capsys):
    _, fa, fq, d = tiny[:4]
    out = d / "out.sam"
    assert cli.main(["mem", fa, fq, "-o", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()
    assert cli.main(["mem", fa, fq, "-o", str(out), "--device", "cpu"]) == 0
    assert out.exists()


def test_server_without_cuda_raises_before_binding(no_cuda, tiny):
    from repro_torch.options import AlignOptions
    from repro_torch.serve import AlignmentServer
    idx = tiny[0]
    # the constructor raises: there is no server to start(), so no socket
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlignmentServer(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AlignmentServer(idx, AlignOptions(device="cuda:0"), port=0)
    srv = AlignmentServer(idx, AlignOptions(device="cpu"))
    assert srv.options.device == "cpu" and srv._sock is None


def test_cli_serve_without_cuda_exits_nonzero(no_cuda, tiny, capsys):
    _, fa, _, d = tiny[:4]
    ready = d / "serve.ready"
    assert cli.main(["serve", fa, "--ready-file", str(ready)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not ready.exists()


def test_lm_entry_points_without_cuda_raise(no_cuda, capsys):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as lm_serve
    from repro_torch.models import lm
    cfg = smoke_config("qwen1.5-0.5b")
    for call in (lambda: lm.init_params(cfg),
                 lambda: lm.init_params(cfg, device="cuda:0"),
                 lambda: lm.init_cache(cfg, 2, 8),
                 lambda: lm.LanguageModel(cfg),
                 lambda: dryrun.run_smoke(pathlib.Path("unwritten")),
                 lambda: dryrun.lower_cell("qwen1.5-0.5b", "train_4k",
                                           False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert lm_serve.main(["--smoke"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert dryrun.main(["--smoke", "--out-dir", "unwritten"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not pathlib.Path("unwritten").exists()
    # asking for the CPU explicitly is the one way to run there
    params, _ = lm.init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
    assert lm_serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                          "--max-new", "2"]) == 0


def test_wrappers_refuse_meta_tensors(tiny):
    idx = tiny[0]
    before = launch_counts()
    fm_meta = tfm.FMArrays(*(t.to("meta") for t in idx.device("cpu")))
    c = torch.zeros(8, dtype=torch.int32, device="meta")
    for layout in ("eta32", "eta128"):
        with pytest.raises(RuntimeError, match="no kernel for device meta"):
            occ(fm_meta, c, c, layout=layout)
        for which in ("bwd", "fwd"):
            with pytest.raises(RuntimeError,
                               match="no kernel for device meta"):
                ext_round(fm_meta, which, c, c, c, c, layout=layout)
    a = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    v = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        bsw_call(a, a, v, v, v, v, BSWParams())
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        bsw_extend_kernel([np.zeros(3, np.uint8)], [np.zeros(3, np.uint8)],
                          [5], BSWParams(), device="meta")
    assert launch_counts() == before


WRAPPERS = ("fmocc", "bsw", "galign", "diagseed")


def imports_of(path: pathlib.Path):
    """(absolute module, whether inside a function) of every import in
    ``path``; ``from a import b`` gives both ``a`` and ``a.b``, since
    ``b`` may be a module."""
    rel = path.relative_to(PKG.parent).with_suffix("")
    pkg = list(rel.parts[:-1])
    out = []

    def walk(node, in_fn):
        for child in ast.iter_child_nodes(node):
            fn = in_fn or isinstance(child, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name, fn, False) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                base = pkg[:len(pkg) - child.level + 1] if child.level \
                    else []
                mod = ".".join(base + ([child.module] if child.module
                                       else []))
                out.append((mod, fn, child.level > 0))
                out.extend((f"{mod}.{a.name}", fn, child.level > 0)
                           for a in child.names)
            walk(child, fn)
    walk(ast.parse(path.read_text()), False)
    return out


def under(mod: str, *prefixes: str) -> bool:
    return any(mod == p or mod.startswith(p + ".") for p in prefixes)


def test_layers_import_one_way():
    bad = []
    for sub in ("core", "pe", "kernels"):
        for path in sorted((PKG / sub).rglob("*.py")):
            name = str(path.relative_to(PKG))
            for mod, in_fn, relative in imports_of(path):
                if sub in ("core", "pe") and in_fn and (
                        relative or under(mod, "repro_torch")):
                    bad.append(f"{name}: deferred import of {mod}")
                if sub == "core" and under(mod, "repro_torch.pe",
                                           "repro_torch.api",
                                           "repro_torch.kernels.engine"):
                    bad.append(f"{name}: core imports {mod}")
                parts = path.relative_to(PKG).parts
                if sub == "kernels" and len(parts) > 2 and \
                        parts[1] in WRAPPERS:
                    others = [f"repro_torch.kernels.{w}" for w in WRAPPERS
                              if w != parts[1]]
                    if under(mod, "repro_torch.core.smem",
                             "repro_torch.core.sal",
                             "repro_torch.core.pipeline", "repro_torch.pe",
                             "repro_torch.api", "repro_torch.kernels.engine",
                             *others):
                        bad.append(f"{name}: wrapper imports {mod}")
    assert bad == []
