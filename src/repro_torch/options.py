"""One flattened options surface for the whole mapper.

Historically every stage grew its own dataclass — ``MemOptions``
(seeding), ``ChainOptions`` (chaining), ``BSWParams`` (extension
scoring), ``PipelineOptions`` (driver knobs) and ``PEOptions``
(paired-end) — and every front-end wired them up by hand.
``AlignOptions`` absorbs all five into ONE frozen dataclass with a
field per knob, projects back onto the per-stage dataclasses via
``mem_options()`` / ``chain_options()`` / ``bsw_params()`` /
``pipeline_options()`` (the stage modules keep their own types so
kernels never grow a dependency on this layer), and maps bwa-mem's
command-line flags onto fields via ``from_flags``; ``pe_options()``
projects the paired-end fields.  ``device`` says where the pipeline
runs: "cuda" (the default) or "cpu".

    -k min seed length     -w band width          -r split factor
    -c max SA occurrences  -A match score         -B mismatch penalty
    -O gap open (del,ins)  -E gap extend (del,ins)
    -L clip penalty (5',3')  -d Z-drop            -T min output score
    -U unpaired penalty    -R read group header line
    -a output all hits     -Y soft-clip supplementary

Fields that bwa keys by one flag but we store split (``-O`` ->
``o_del``/``o_ins``) accept bwa's ``INT[,INT]`` syntax.
"""

from __future__ import annotations

import dataclasses

from .core.bsw import BSWParams
from .core.chain import ChainOptions
from .core.pipeline import PipelineOptions
from .core.smem import MemOptions
from .pe.rescue import PEOptions

ENGINE_CUDA = "cuda"
ENGINE_BASELINE = "baseline"


@dataclasses.dataclass(frozen=True)
class AlignOptions:
    """Every mapper knob, flattened (bwa-mem defaults)."""

    # --- seeding (MemOptions) ---
    min_seed_len: int = 19          # -k (also chaining's seed floor)
    split_factor: float = 1.5       # -r
    split_width: int = 10
    max_mem_intv: int = 20
    max_occ: int = 500              # -c

    # --- chaining (ChainOptions) ---
    max_chain_gap: int = 10000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    min_chain_weight: int = 0

    # --- extension scoring (BSWParams; band shared with chaining) ---
    band_width: int = 100           # -w
    match: int = 1                  # -A
    mismatch: int = 4               # -B
    o_del: int = 6                  # -O
    e_del: int = 1                  # -E
    o_ins: int = 6                  # -O (second value)
    e_ins: int = 1                  # -E (second value)
    zdrop: int = 100                # -d
    end_bonus: int = 5
    pen_clip5: int = 5              # -L
    pen_clip3: int = 5              # -L (second value)

    # --- emission ---
    min_score: int = 30             # -T (SE regions AND rescue acceptance)
    all_hits: bool = False          # -a: also emit secondary (0x100) records
    softclip_supp: bool = False     # -Y: soft-clip supplementary records
    read_group: str | None = None   # -R '@RG\tID:...' (None: no RG)

    # --- paired-end (PEOptions) ---
    max_ins: int = 10000
    pen_unpaired: int = 17          # -U
    max_matesw: int = 2
    rescue_min_seed: int = 10
    mapq_blend: bool = True

    # --- engine/driver knobs (PipelineOptions extras) ---
    engine: str = ENGINE_CUDA       # registry name; see repro_torch.api
    bsw_sort: bool = True
    device: str = "cuda"            # "cuda[:n]" or "cpu"

    # -- projections onto the per-stage dataclasses --

    def mem_options(self) -> MemOptions:
        return MemOptions(min_seed_len=self.min_seed_len,
                          split_factor=self.split_factor,
                          split_width=self.split_width,
                          max_mem_intv=self.max_mem_intv,
                          max_occ=self.max_occ)

    def chain_options(self) -> ChainOptions:
        return ChainOptions(w=self.band_width,
                            max_chain_gap=self.max_chain_gap,
                            mask_level=self.mask_level,
                            drop_ratio=self.drop_ratio,
                            min_seed_len=self.min_seed_len,
                            min_chain_weight=self.min_chain_weight)

    def bsw_params(self) -> BSWParams:
        return BSWParams(a=self.match, b=self.mismatch,
                         o_del=self.o_del, e_del=self.e_del,
                         o_ins=self.o_ins, e_ins=self.e_ins,
                         w=self.band_width, zdrop=self.zdrop,
                         end_bonus=self.end_bonus,
                         pen_clip5=self.pen_clip5,
                         pen_clip3=self.pen_clip3)

    def pipeline_options(self) -> PipelineOptions:
        return PipelineOptions(mem=self.mem_options(),
                               chain=self.chain_options(),
                               bsw=self.bsw_params(),
                               bsw_sort=self.bsw_sort,
                               min_score=self.min_score,
                               all_hits=self.all_hits,
                               softclip_supp=self.softclip_supp,
                               device=self.device)

    def pe_options(self) -> PEOptions:
        return PEOptions(max_ins=self.max_ins,
                         pen_unpaired=self.pen_unpaired,
                         max_matesw=self.max_matesw,
                         rescue_min_seed=self.rescue_min_seed,
                         min_score=self.min_score,
                         mapq_blend=self.mapq_blend)

    def replace(self, **kw) -> "AlignOptions":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_flags(cls, flags: dict, base: "AlignOptions | None" = None,
                   **extra) -> "AlignOptions":
        """Build options from bwa-mem flag spellings.

        ``flags`` maps flag strings to values (``{"-k": 20, "-O": "6,8"}``);
        paired flags (-O/-E/-L) take bwa's ``INT[,INT]`` — one value sets
        both fields.  ``extra`` passes field names directly.
        """
        kw = dict(extra)
        for flag, value in flags.items():
            if value is None:
                continue
            try:
                target, conv = BWA_FLAGS[flag]
            except KeyError:
                raise ValueError(f"unknown bwa flag {flag!r} "
                                 f"(known: {' '.join(sorted(BWA_FLAGS))})")
            if isinstance(target, tuple):
                parts = [p for p in str(value).split(",") if p != ""]
                if not 1 <= len(parts) <= len(target):
                    raise ValueError(
                        f"{flag} takes INT[,INT], got {value!r}")
                if len(parts) == 1:
                    parts = parts * len(target)
                for name, part in zip(target, parts):
                    kw[name] = conv(part)
            else:
                kw[target] = conv(value)
        return dataclasses.replace(base or cls(), **kw)


#: bwa-mem flag -> AlignOptions field(s).  Tuple targets take ``INT[,INT]``.
BWA_FLAGS: dict = {
    "-k": ("min_seed_len", int),
    "-w": ("band_width", int),
    "-r": ("split_factor", float),
    "-c": ("max_occ", int),
    "-A": ("match", int),
    "-B": ("mismatch", int),
    "-O": (("o_del", "o_ins"), int),
    "-E": (("e_del", "e_ins"), int),
    "-L": (("pen_clip5", "pen_clip3"), int),
    "-d": ("zdrop", int),
    "-T": ("min_score", int),
    "-U": ("pen_unpaired", int),
    "-R": ("read_group", str),
    "-a": ("all_hits", bool),
    "-Y": ("softclip_supp", bool),
}


def parse_read_group(rg: str) -> tuple[str, str]:
    """bwa -R: ``'@RG\\tID:sample'`` -> (header line, RG ID).

    Accepts literal backslash-t sequences (the shell-quoted spelling bwa
    documents) as well as real tabs; the returned header line always uses
    real tabs.  The line must start with ``@RG`` and carry an ``ID:``
    field — that ID lands in the ``RG:Z:`` tag of every record.
    """
    line = rg.replace("\\t", "\t")
    if not line.startswith("@RG"):
        raise ValueError(f"read group line must start with @RG: {rg!r}")
    rg_id = None
    for field in line.split("\t")[1:]:
        if field.startswith("ID:") and len(field) > 3:
            rg_id = field[3:]
            break
    if rg_id is None:
        raise ValueError(f"read group line carries no ID: field: {rg!r}")
    return line, rg_id
