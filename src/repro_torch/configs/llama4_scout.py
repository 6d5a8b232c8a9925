"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
— MoE 16 experts top-1, GQA kv=8, early-fusion frontend stubbed.

NOTE: 40 q-heads are NOT divisible by the model=16 mesh axis; the
baseline sharding rule replicates the head axis (see DESIGN.md §6) and the
§Perf hillclimb pads heads 40->48 to re-enable TP."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    act="swiglu", rope_theta=500000.0,
    moe_experts=16, moe_top_k=1,
)
