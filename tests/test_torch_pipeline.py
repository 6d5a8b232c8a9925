"""Single-end ``mem`` of the port on the CPU path, SAM byte-identical to
the reference's ``pallas`` (Pallas in interpret mode) and ``batched``
engines: the SE golden, a 3-contig world, zero-length and all-N reads,
telemetry on and off, the two CLIs on the same files, and a bundle
written by the reference loaded by the port."""

import numpy as np
import pytest
import torch

from repro import cli as rcli
from repro.api import Aligner as RAligner
from repro.core.contig import build_contig_index as r_build_contig_index
from repro.io.store import save_index as r_save_index
from repro.options import AlignOptions as RAlignOptions
from repro_torch import cli as tcli
from repro_torch.api import Aligner, engines, get_engine
from repro_torch.core.contig import build_contig_index
from repro_torch.data import (make_reference, simulate_reads,
                              simulate_reads_multi, simulate_reference,
                              write_fasta, write_fastq)
from repro_torch.io.store import load_index
from repro_torch.kernels import engine as cuda_engine
from repro_torch.options import AlignOptions

torch.set_num_threads(1)

REF_ENGINES = ("pallas", "batched")


def ref_sam(contigs, reads, engine, lens=None):
    idx = r_build_contig_index(contigs)
    return RAligner(idx, RAlignOptions(engine=engine)).align(
        reads, lens=lens).sam()


@pytest.fixture(scope="module")
def se_world():
    contigs = [("ref", make_reference(12000, seed=7))]
    reads, _ = simulate_reads(contigs[0][1], 8, 101, seed=3)
    return contigs, reads, build_contig_index(contigs)


@pytest.fixture(scope="module")
def contig_world():
    contigs = simulate_reference(30000, 3, seed=11)
    reads, _ = simulate_reads_multi(contigs, 10, 101, seed=13)
    return contigs, reads, build_contig_index(contigs)


@pytest.fixture(scope="module")
def se_want(se_world):
    contigs, reads, _ = se_world
    return {e: ref_sam(contigs, reads, e) for e in REF_ENGINES}


def test_engine_registry():
    assert engines() == ["baseline", "cuda"]
    assert AlignOptions().engine == "cuda" and AlignOptions().device == "cuda"
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("pallas")


@pytest.mark.parametrize("eta128_ms, picked", [
    (0.96, ("eta32", 256)),     # within the margin: the default stays
    (0.90, ("eta128", 256)),    # clearly faster: it displaces the default
])
def test_occ_sweep_pick_margin(monkeypatch, eta128_ms, picked):
    timings = {("eta32", 256): 1.0, ("eta32", 512): 0.99,
               ("eta128", 256): eta128_ms}
    monkeypatch.setattr(cuda_engine, "sweep_timings", lambda idx, dev: timings)
    cfg = cuda_engine.sweep_occ_configs(None, "cuda")
    assert (cfg.layout, cfg.block) == picked
    # no timing at all on the CPU
    assert cuda_engine.sweep_occ_configs(None, "cpu").layout == "eta32"


@pytest.mark.parametrize("engine", REF_ENGINES)
def test_se_golden_identity(se_world, se_want, engine):
    _, reads, idx = se_world
    got = Aligner(idx, device="cpu").align(reads)
    assert got.sam() == se_want[engine]
    assert got.n_mapped > 0


@pytest.mark.parametrize("telemetry", [True, False])
def test_se_golden_telemetry(se_world, se_want, telemetry):
    _, reads, idx = se_world
    got = Aligner(idx, AlignOptions(device="cpu"),
                  telemetry=telemetry).align(reads)
    assert got.sam() == se_want["pallas"]
    if telemetry:
        st = got.stats
        assert st["kernel_bsw_dispatches"] > 0
        assert st["smem_rounds"] > 0
        assert st["time_smem_s"] > 0 and st["time_bsw_s"] > 0
        assert st["occ_kernel"] == "eta32/256"
    else:
        assert "smem_rounds" not in got.stats


@pytest.mark.parametrize("engine", REF_ENGINES)
def test_multicontig_identity(contig_world, engine):
    contigs, reads, idx = contig_world
    got = Aligner(idx, device="cpu").align(reads)
    assert got.sam() == ref_sam(contigs, reads, engine)
    assert len({r.rname for r in got.records()} - {"*"}) >= 2


def test_zero_length_and_all_n_reads(se_world):
    contigs, reads, idx = se_world
    L = reads.shape[1]
    batch = np.vstack([reads[:2], np.full((1, L), 4, reads.dtype),
                       reads[2:3]])
    lens = np.array([L, L, L, 0])
    got = Aligner(idx, device="cpu").align(batch, lens=lens)
    for engine in REF_ENGINES:
        assert got.sam() == ref_sam(contigs, batch, engine, lens=lens)
    recs = got.records()
    assert recs[-1].is_unmapped
    assert any(r.qname == "read2" and r.is_unmapped for r in recs)


@pytest.fixture(scope="module")
def files(tmp_path_factory, contig_world):
    contigs, reads, _ = contig_world
    d = tmp_path_factory.mktemp("torch_cli")
    fa, fq = str(d / "ref.fa.gz"), str(d / "reads.fq")
    write_fasta(fa, contigs)
    write_fastq(fq, reads)
    return d, fa, fq


def body(path):
    with open(path) as f:
        return f.read()


def test_cli_identity_with_reference_cli(files):
    d, fa, fq = files
    assert tcli.main(["index", fa]) == 0
    out_t, out_r = str(d / "torch.sam"), str(d / "ref.sam")
    assert tcli.main(["mem", fa, fq, "-o", out_t, "--device", "cpu",
                      "--no-pg", "-b", "4"]) == 0
    assert rcli.main(["mem", fa, fq, "-o", out_r, "--engine", "pallas",
                      "--no-pg", "-b", "4"]) == 0
    assert body(out_t) == body(out_r)
    assert "\n@SQ\tSN:chr1\t" in body(out_t)


def test_bundle_from_reference_store(tmp_path, contig_world):
    contigs, reads, idx = contig_world
    r_save_index(tmp_path / "rb", r_build_contig_index(contigs))
    loaded = load_index(tmp_path / "rb")
    assert loaded.names == idx.names
    for k in ("sa", "bwt", "occ32_bytes", "occ128_packed", "edges"):
        assert np.array_equal(getattr(loaded, k), getattr(idx, k))
    want = Aligner(idx, device="cpu").align(reads).sam()
    assert Aligner(loaded, device="cpu").align(reads).sam() == want
    assert Aligner.from_bundle(tmp_path / "rb",
                               device="cpu").align(reads).sam() == want
