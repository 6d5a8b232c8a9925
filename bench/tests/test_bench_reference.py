"""The plain reference against the port on the CPU, and the comparison
against its control and against faults planted in the port."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

from bench import control, harness
from bench.frozen.genome import bundle, make_genome
from bench.frozen.reads import Simulator, Traffic


def _cell(checkout, name):
    return harness.load_cell(name, checkout)


@pytest.mark.parametrize("name", ["tiny-se.wgsim", "tiny-pe.wgsim"])
def test_reference_equals_the_port_on_the_cpu(checkout, name):
    from repro_torch.api import Aligner
    from repro_torch.options import AlignOptions
    cell = _cell(checkout, name)
    ref = harness.reference(cell)
    prefix = bundle(cell.config["genome"], cell.index_cache)
    sim = Simulator(make_genome(cell.config["genome"]),
                    Traffic.from_json(cell.traffic), 31,
                    read_len=cell.read_len, paired=cell.paired)
    flags = cell.config["options"]
    port = Aligner.from_bundle(prefix, AlignOptions.from_flags(flags),
                               device="cpu")
    idx = ref.load_index(prefix)
    pick = np.arange(cell.chunk_items)
    if cell.paired:
        names, r1, r2 = sim.reads(pick)
        got = port.align_pairs(r1, r2, names=names).sam()
        want = ref.align_pe(idx, r1, r2, names, flags, "cpu")
    else:
        names, reads = sim.reads(pick)
        got = port.align(reads, names=names).sam()
        want = ref.align_se(idx, reads, names, flags, "cpu")
    assert got == want and len(want) >= len(pick)
    assert port.sam_header() == ref.sam_header(idx)


@pytest.mark.parametrize("name", ["tiny-se.wgsim", "tiny-pe.wgsim"])
def test_control_is_not_correct(checkout, name):
    r = control.control_reading(name, 12345, 2, "cpu", root=checkout)
    assert r["reads_compared"] > 0 and r["reads_differing"] > 0
    assert r["correct"] is False


@contextlib.contextmanager
def _patched(obj, attr, make):
    real = getattr(obj, attr)
    setattr(obj, attr, make(real))
    try:
        yield
    finally:
        setattr(obj, attr, real)


def _alter_answer(paired):
    """One read's record altered where it is produced."""
    if paired:
        import repro_torch.pe as pe

        def make(real):
            def emit_pair(qname, *a, **kw):
                two, proper = real(qname, *a, **kw)
                if qname == "p7":
                    two = [two[0].replace("\t", "\t1", 1)] + two[1:]
                return two, proper
            return emit_pair
        return _patched(pe, "emit_pair", make)
    import repro_torch.api as api

    def make(real):
        def format_sam(qname, read, aln, idx=None):
            line = real(qname, read, aln, idx)
            return line + "\tXX:i:1" if qname == "r7" else line
        return format_sam
    return _patched(api, "format_sam", make)


def _half_left_out(paired):
    """Each batch mapped and written for its first half only."""
    from repro_torch.api import Aligner

    def make(real):
        def half(self, batch, *a, **kw):
            n = len(batch) // 2
            if paired:
                from repro_torch.io.stream import PairBatch
                batch = PairBatch(batch.names[:n], batch.reads1[:n],
                                  batch.reads2[:n], batch.lens1[:n],
                                  batch.lens2[:n])
            else:
                from repro_torch.io.stream import ReadBatch
                batch = ReadBatch(batch.names[:n], batch.reads[:n],
                                  batch.lens[:n])
            return real(self, batch, *a, **kw)
        return half
    return _patched(Aligner, "align_pairs" if paired else "align", make)


def _state_unchanged(paired):
    """The BSW step returns each extension's state unchanged."""
    import repro_torch.kernels.bsw as bsw_pkg
    from repro_torch.core.bsw import ExtResult

    def make(real):
        def unchanged(queries, targets, h0s, p, *a, **kw):
            return [ExtResult(int(h), 0, 0, 0, -1, 0) for h in h0s]
        return unchanged
    return _patched(bsw_pkg, "bsw_extend_kernel", make)


@pytest.mark.parametrize("fault", [_alter_answer, _half_left_out,
                                   _state_unchanged])
@pytest.mark.parametrize("name", ["tiny-se.wgsim", "tiny-pe.wgsim"])
def test_a_fault_in_the_port_is_not_correct(checkout, name, fault):
    paired = name.startswith("tiny-pe")
    with fault(paired):
        out = harness.run_cell(name, 4242, 0.5, False, device="cpu",
                               root=checkout)
    assert out["correct"] is False


@pytest.mark.card
def test_tiny_cells_on_the_card(checkout, card):
    for name in ("tiny-se.wgsim", "tiny-pe.wgsim"):
        for trace in (False, True):
            out = harness.run_cell(name, 77, 2.0, trace, device="cuda",
                                   root=checkout)
            assert out["correct"] is True
            if trace:
                assert out["device"]["busy_s"] > 0
