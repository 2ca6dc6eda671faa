"""Model-config passes: static invariants of shipped ModelConfigs.

The model layer assumes these silently (``layer_kinds`` raises only when
called, GQA repeats ``n_heads // n_kv`` heads, the MoE router top-ks over
``moe_experts`` logits); the analyzer states them once and checks every
shipped config before a forward pass exists to crash.
"""
from __future__ import annotations

from typing import List, Optional

from .findings import Finding, finding


def analyze_model_config(cfg, location: Optional[str] = None) -> List[Finding]:
    """Analyze one :class:`~repro_torch.configs.base.ModelConfig`."""
    loc = location or cfg.name
    fs: List[Finding] = []
    try:
        cfg.layer_kinds()
        cfg.ffn_kinds()
    except ValueError as e:
        fs.append(finding("config-layer-pattern", loc, str(e)))
    if cfg.moe_experts > 0 and cfg.moe_topk > cfg.moe_experts:
        fs.append(finding(
            "config-moe-topk", loc,
            f"moe_topk={cfg.moe_topk} exceeds moe_experts="
            f"{cfg.moe_experts}: the router cannot pick more experts "
            f"than exist",
        ))
    if cfg.n_kv < 1 or cfg.n_heads % cfg.n_kv != 0:
        fs.append(finding(
            "config-head-grouping", loc,
            f"n_kv={cfg.n_kv} does not divide n_heads={cfg.n_heads}: GQA "
            f"repeats each KV head n_heads/n_kv times",
        ))
    if cfg.head_dim is None and cfg.d_model % cfg.n_heads != 0:
        fs.append(finding(
            "config-head-grouping", loc,
            f"head_dim is unset and n_heads={cfg.n_heads} does not "
            f"divide d_model={cfg.d_model}",
        ))
    return fs
