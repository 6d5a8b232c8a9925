"""Clients and servers across the two packages, and the port's ``cli
serve``:

* ``repro.serve.ServeClient`` against the port's server, and the port's
  client against the reference's server (``pallas`` engine): the same
  wire protocol, the same bytes, each equal to both packages' offline
  ``stream_sam``;
* a request for an engine that is not registered gets the same
  structured error code from either server, and the server keeps serving;
* ``python -m repro_torch.cli serve --device cpu --ready-file`` in a
  subprocess answers one request byte-identical to ``repro_torch.cli mem
  --device cpu --no-pg`` on the same reads, and SIGINT drains it to exit
  0 with a ``serve_stop`` event in its run log;
* ``--engine`` with a name the port's CLI does not offer (it takes
  ``cuda`` and ``baseline``) exits 2 before any work.
"""

from __future__ import annotations

import io
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

from repro import serve as rserve
from repro.api import Aligner as RAligner
from repro.core import fmindex as rfmx
from repro.io.stream import _pack_pe as r_pack_pe
from repro.io.stream import _pack_se as r_pack_se
from repro.options import AlignOptions as RAlignOptions
from repro_torch import cli, obs, serve
from repro_torch.api import Aligner
from repro_torch.core import fmindex as fmx
from repro_torch.data import (decode, make_reference, simulate_pairs,
                              simulate_reads, write_fasta, write_fastq)
from repro_torch.io.stream import _pack_pe, _pack_se
from repro_torch.options import AlignOptions

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = AlignOptions(device="cpu")
RPALLAS = RAlignOptions(engine="pallas")


def offline(al, batch) -> list[str]:
    buf = io.StringIO()
    al.stream_sam([batch], buf, header=True)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def world():
    """The 30-kbp world of ``tests/test_serve.py``: both indexes, its
    reads and pairs, and the offline SAM (header and body) that both
    packages give for them."""
    ref = make_reference(30000, seed=5)
    idx, ridx = fmx.build_index(ref), rfmx.build_index(ref)
    reads, _ = simulate_reads(ref, 12, 101, seed=3)
    r1, r2, _ = simulate_pairs(ref, 10, 101, insert_mean=300, insert_std=30,
                               seed=9, burst_frac=0.2)
    se = [(f"read{i}", decode(r)) for i, r in enumerate(reads)]
    pe = [(f"pair{i}", decode(a), decode(b))
          for i, (a, b) in enumerate(zip(r1, r2))]
    se_args = ([n for n, _ in se], [s for _, s in se])
    pe_args = ([n for n, _, _ in pe], [a for _, a, _ in pe],
               [b for _, _, b in pe])
    want = {"se": offline(Aligner(idx, CPU), _pack_se(*se_args)),
            "pe": offline(Aligner(idx, CPU), _pack_pe(*pe_args))}
    assert want["se"] == offline(RAligner(ridx, RPALLAS),
                                 r_pack_se(*se_args))
    assert want["pe"] == offline(RAligner(ridx, RPALLAS),
                                 r_pack_pe(*pe_args))
    return dict(ref=ref, idx=idx, ridx=ridx, reads=reads, se=se, pe=pe,
                want=want)


def body(lines) -> list[str]:
    return [ln for ln in lines if not ln.startswith("@")]


def header(lines) -> list[str]:
    return [ln for ln in lines if ln.startswith("@")]


@pytest.mark.parametrize("side", ["reference_client", "port_client"])
def test_clients_and_servers_across_packages(world, side):
    """The reference's client against the port's server, or the port's
    client against the reference's server: the same bytes either way."""
    if side == "reference_client":
        srv = serve.AlignmentServer(world["idx"], CPU)
        client = rserve.ServeClient
    else:
        srv = rserve.AlignmentServer(world["ridx"], RPALLAS)
        client = serve.ServeClient
    srv.start()
    try:
        with client.connect(*srv.address) as c:
            res = c.align(world["se"], header=True)
            assert res.header == header(world["want"]["se"])
            assert res.sam == body(world["want"]["se"])
            assert c.align_pairs(world["pe"]).sam == body(world["want"]["pe"])
            assert c.ping()["type"] == "pong"
    finally:
        srv.shutdown()


def test_unknown_engine_same_error_code(world):
    """``engine: "nope"`` fails the request with one structured code on
    either server (the engine registry raises inside the batch), and the
    connection and the server go on serving."""
    se = world["se"][:2]
    codes = []
    for srv in (serve.AlignmentServer(world["idx"], CPU),
                rserve.AlignmentServer(world["ridx"], RPALLAS)):
        srv.start()
        try:
            with serve.ServeClient.connect(*srv.address) as c:
                with pytest.raises(serve.ServeError) as ei:
                    c.align(se, engine="nope")
                codes.append(ei.value.code)
                assert "unknown engine 'nope'" in ei.value.message
                assert c.align(se).sam == [
                    ln for ln in body(world["want"]["se"])
                    if ln.split("\t", 1)[0] in ("read0", "read1")]
        finally:
            srv.shutdown()
    assert codes == [serve.ERR_INTERNAL, rserve.ERR_INTERNAL]


def test_cli_engine_flag_exits_2(world, tmp_path, capsys):
    fa = str(tmp_path / "ref.fa")
    write_fasta(fa, [("chrT", world["ref"])])
    ready = tmp_path / "ready"
    with pytest.raises(SystemExit) as ei:
        cli.main(["serve", fa, "--device", "cpu", "--engine", "nope",
                  "--ready-file", str(ready)])
    assert ei.value.code == 2
    assert "--engine" in capsys.readouterr().err
    assert not ready.exists()


def _wait_ready(proc, ready: pathlib.Path, timeout: float = 120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if ready.exists() and ready.read_text().endswith("\n"):
            host, port = ready.read_text().split()
            return host, int(port)
        if proc.poll() is not None:
            raise AssertionError(f"cli serve exited {proc.returncode}: "
                                 f"{proc.stderr.read()}")
        time.sleep(0.1)
    raise AssertionError("cli serve wrote no ready file")


def test_cli_serve_subprocess_matches_cli_mem(world, tmp_path):
    fa, fq = tmp_path / "ref.fa", tmp_path / "reads.fq"
    write_fasta(fa, [("chrT", world["ref"])])
    names = [n for n, _ in world["se"]]
    write_fastq(fq, world["reads"], names)
    assert cli.main(["index", str(fa)]) == 0
    out = tmp_path / "mem.sam"
    assert cli.main(["mem", str(fa), str(fq), "--device", "cpu", "--no-pg",
                     "-o", str(out)]) == 0
    ready, rl = tmp_path / "ready", tmp_path / "serve.runlog.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.cli", "serve", str(fa),
         "--device", "cpu", "--ready-file", str(ready), "--runlog", str(rl)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        host, port = _wait_ready(proc, ready)
        with serve.ServeClient.connect(host, port) as c:
            res = c.align(world["se"], header=True)
        assert res.header + res.sam == out.read_text().splitlines()
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    kinds = [e["event"] for e in obs.read_runlog(rl)]
    assert kinds[-2:] == ["serve_stop", "run_end"]
    assert kinds.count("request_done") == 1 and "crash" not in kinds
