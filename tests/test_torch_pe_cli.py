"""Paired-end ``repro_torch.cli mem --device cpu`` against ``repro.cli mem
--engine pallas`` on the same files: split R1/R2, interleaved (``-p``),
and ``-K`` chunks with ``--pe-bootstrap``, byte for byte; and the
refusal of ``--pe-bootstrap`` without ``-K`` or on single-end input,
with the reference's exit code and message."""

import numpy as np
import pytest
import torch

from repro import cli as rcli
from repro_torch import cli as tcli
from repro_torch.data import (make_reference, simulate_pairs, write_fasta,
                              write_fastq, write_fastq_pair)

torch.set_num_threads(1)

N_PAIRS = 48


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pe_cli")
    ref = make_reference(30_000, seed=5)
    r1, r2, _ = simulate_pairs(ref, N_PAIRS, 101, insert_mean=300,
                               insert_std=30, seed=9, burst_frac=0.25)
    fa, fq1, fq2, il = (str(d / n) for n in
                        ("ref.fa", "r1.fq", "r2.fq", "il.fq.gz"))
    write_fasta(fa, [("chrA", ref)])
    write_fastq_pair(fq1, fq2, r1, r2)
    names = [f"pair{i}/{e}" for i in range(N_PAIRS) for e in (1, 2)]
    write_fastq(il, np.stack([r1, r2], axis=1).reshape(2 * N_PAIRS, -1),
                names)
    assert tcli.main(["index", fa]) == 0
    return d, fa, fq1, fq2, il


def read(path):
    with open(path) as f:
        return f.read()


#: -b 32: two batches, each estimating its own insert-size stats;
#: -K 6464: two fixed-base chunks (32 and 16 pairs), the stats frozen
#: from the first
MODES = {"split": ("{fq1}", "{fq2}", "-b", "32"),
         "interleaved": ("-p", "{il}", "-b", "32"),
         "chunks_bootstrap": ("{fq1}", "{fq2}", "-K", "6464",
                              "--pe-bootstrap")}


@pytest.mark.parametrize("mode", MODES)
def test_cli_pe_identity_with_reference_cli(files, mode):
    d, fa, fq1, fq2, il = files
    args = [a.format(fq1=fq1, fq2=fq2, il=il) for a in MODES[mode]]
    out_t, out_r = str(d / f"{mode}.torch.sam"), str(d / f"{mode}.ref.sam")
    assert tcli.main(["mem", fa, *args, "-o", out_t, "--device", "cpu",
                      "--no-pg"]) == 0
    assert rcli.main(["mem", fa, *args, "-o", out_r, "--engine", "pallas",
                      "--no-pg"]) == 0
    body = read(out_t)
    assert body == read(out_r)
    recs = [ln.split("\t") for ln in body.splitlines()
            if not ln.startswith("@")]
    assert len(recs) == 2 * N_PAIRS
    assert any(int(f[1]) & 0x2 for f in recs)        # proper pairs


@pytest.mark.parametrize("case", ["paired_without_K", "single_end_with_K"])
def test_cli_pe_bootstrap_refused(files, capsys, case):
    d, fa, fq1, fq2, _ = files
    args = ([fq1, fq2] if case == "paired_without_K"
            else [fq1, "-K", "5000"])
    out = d / f"{case}.sam"
    assert tcli.main(["mem", fa, *args, "--pe-bootstrap", "--device", "cpu",
                      "-o", str(out)]) == 2
    msg = "--pe-bootstrap needs paired input and -K"
    assert msg in capsys.readouterr().err
    assert not out.exists()
    assert rcli.main(["mem", fa, *args, "--pe-bootstrap", "--engine",
                      "pallas", "-o", str(out)]) == 2
    assert msg in capsys.readouterr().err
