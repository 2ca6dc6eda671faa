"""Findings model + rule catalog of the static analyzer.

A :class:`Finding` is one violated (or advisory) property: a rule id from
the :data:`RULES` catalog, a severity, the location it anchors to (a
schema/target name, a config field, a demand entry), the human message,
and the rule's fix hint.  Pass functions (``schema_passes``,
``fabric_passes``, ``config_passes``) return lists of findings; a
:class:`Report` aggregates them for the CLI / the ``analyze=True`` hooks.

The catalog is the single place a rule's severity and fix hint are
defined, so the CLI report, the README rule table, and the exceptions the
runtime hooks raise can never disagree about what a rule means.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional


class Severity(enum.IntEnum):
    """ERROR = the config/schema WILL fail at runtime; WARN = it can fail
    or silently misbehave under some demand; INFO = advisory only."""

    INFO = 0
    WARN = 1
    ERROR = 2


@dataclass(frozen=True)
class Rule:
    """One catalog entry: what the rule proves when it does NOT fire."""

    id: str
    severity: Severity
    proves: str  # the property that holds when the rule is silent
    hint: str  # how to fix a firing


#: every rule the analyzer can emit, keyed by id (see README "Static
#: analysis" for the rendered table)
RULES: Dict[str, Rule] = {
    r.id: r
    for r in [
        # -- schema passes (core/idl.py + schema_tree.py) -------------------
        Rule("schema-undefined-struct", Severity.ERROR,
             "every StructRef resolves to a defined struct",
             "define the struct or fix the reference name"),
        Rule("schema-recursive", Severity.ERROR,
             "the schema tree is finite (no recursive struct cycles)",
             "break the cycle — HGum messages are finite trees"),
        Rule("schema-empty-struct", Severity.ERROR,
             "struct inlining never produces an empty node group",
             "give the struct at least one field or drop the reference"),
        Rule("schema-unreachable-struct", Severity.WARN,
             "every defined struct is reachable from the top message",
             "delete the dead struct or reference it from the message"),
        Rule("schema-rom-capacity", Severity.ERROR,
             "the flattened schema tree fits the schema-ROM capacity",
             "split the message into smaller schemas (or raise "
             "ROM_CAPACITY together with the hardware BRAM budget)"),
        Rule("schema-stack-depth", Severity.ERROR,
             "container nesting fits the DES/SER context-stack capacity",
             "flatten the nesting (or raise STACK_CAPACITY together with "
             "the hardware stack)"),
        Rule("schema-list-level-overflow", Severity.ERROR,
             "List nesting depth fits the u8 ListLevel header lane",
             "keep List nesting depth <= 255"),
        Rule("client-tag-collision", Severity.ERROR,
             "each client-schema tag names a unique token path",
             "assign every tagged path a distinct tag — the DES emits "
             "(tag, value) pairs, so shared tags are indistinguishable"),
        Rule("client-unknown-path", Severity.ERROR,
             "every client-schema path names a real token of the schema",
             "fix the path (fields dotted from the top struct; container "
             "suffixes are .start/.end/.elem)"),
        Rule("plan-cap-count-width", Severity.ERROR,
             "decode-plan caps fit the u32 count field",
             "keep per-path caps below 2**32"),
        Rule("plan-cap-overflow", Severity.WARN,
             "nested caps hold at least one element per enclosing "
             "container instance",
             "raise the inner path's cap to >= the enclosing container's "
             "cap (plan_from_wire raises the moment real instances "
             "exceed a cap)"),
        # -- fabric / communication passes ---------------------------------
        Rule("fabric-config-positive", Severity.ERROR,
             "frame_phits and credits are positive",
             "set frame_phits >= 1 and credits >= 1"),
        Rule("fabric-routing-mode", Severity.ERROR,
             "routing names a known discipline",
             "use routing='shortest' or routing='dimension'"),
        Rule("fabric-defect-config", Severity.ERROR,
             "defection is only enabled where it can act",
             "set defect_after >= 0 and pair defect_after > 0 with "
             "routing='shortest' (only adaptive frames may defect)"),
        Rule("fabric-defect-bound", Severity.WARN,
             "a starved frame defects before it could have ridden the "
             "whole ring",
             "set defect_after below the ring size — a longer wait "
             "inflates the scan bound past the dimension-order worst case "
             "with no path left to escape to"),
        Rule("fabric-qos-weights", Severity.ERROR,
             "QoS weights are positive",
             "use weights >= 1 (drop qos_weights for single-class FIFO)"),
        Rule("fabric-credit-deadlock", Severity.ERROR,
             "every QoS class holds at least one link credit",
             "raise credits to >= len(qos_weights) or merge classes — a "
             "zero-credit class can never inject, its frames wait "
             "forever, and the tick never drains"),
        Rule("fabric-qos-quota-floor", Severity.WARN,
             "no class's largest-remainder credit share floors to zero",
             "rebalance qos_weights or raise credits so every class "
             "earns >= 1 credit by weight instead of surviving on the "
             "floor bump (a floored class runs at 1 credit/step however "
             "congested its traffic)"),
        Rule("fabric-max-ranks", Severity.ERROR,
             "the fabric's rank count fits the route word's u7 src lane",
             "keep n_ranks <= MAX_RANKS (128) or widen the route word"),
        Rule("fabric-list-level", Severity.ERROR,
             "send ListLevels fit the u8 header lane",
             "keep list_level in [0, 255] — larger values wrap and alias "
             "another tenant's QoS class"),
        Rule("fabric-rank-range", Severity.ERROR,
             "every demand entry's src/dst is a real rank",
             "fix the demand matrix — an out-of-range dst is "
             "undeliverable and fails the whole tick"),
        Rule("fabric-rx-overflow", Severity.ERROR,
             "per-rank deliveries fit the configured rx_frames capacity",
             "raise FabricConfig.rx_frames (or leave it None to size "
             "from the tick) — overflow drops frames and fails the tick"),
        Rule("fabric-seq-window", Severity.ERROR,
             "one tick's frames per (src, dst) stream fit the u16 seq "
             "window",
             "split the burst across ticks — seq aliasing breaks the "
             "receiver's reorder-by-seq reassembly"),
        Rule("fabric-arq-config", Severity.ERROR,
             "the ARQ knobs are in range (timeout >= 1, retries >= 0, "
             "buffer >= 1, control level fits the u8 lane)",
             "fix the out-of-range ARQ field (or set arq=False)"),
        Rule("fabric-arq-window", Severity.ERROR,
             "the retransmit buffer stays inside half the u16 seq window "
             "so cumulative ACKs are unambiguous",
             "keep arq_buffer < SEQ_MOD // 2 — past that a retransmit "
             "may alias a message half a window away"),
        Rule("fabric-arq-control-class", Severity.ERROR,
             "the ACK/NACK control class earns a nonzero "
             "weight-proportional credit share",
             "raise the control class's qos weight (or move arq_level to "
             "a heavier class) — recovery liveness depends on control "
             "frames draining every step, not on the floor bump"),
        Rule("fabric-arq-timeout", Severity.ERROR,
             "skip and blackout-detection horizons sit above the "
             "retransmit timeout",
             "set arq_skip_after and suspect_after > retransmit_timeout "
             "so a healthy peer's first retransmit can arrive before it "
             "is skipped or suspected"),
        # -- stream plane ---------------------------------------------------
        Rule("stream-chunk-tokens", Severity.ERROR,
             "a chunk's token count fits the count-word sanity bound",
             "split the step's tokens across chunks below "
             "MAX_CHUNK_TOKENS"),
        Rule("stream-id-width", Severity.ERROR,
             "stream ids fit the (request:u16 | prompt:u16) packing",
             "serve fewer than 2**16 requests (and prompts per request) "
             "per streaming call"),
        Rule("stream-meta-budget", Severity.ERROR,
             "fragment-meta bit budgets fit their u32 wire words",
             "keep id_bits and step_bits in [1, 32] — stream_id, step, "
             "and flags each ride exactly one u32 fragment-meta word"),
        Rule("stream-elem-size", Severity.ERROR,
             "stream elements are fixed-size and the largest fragment "
             "stays u32 word-addressable",
             "give the stream element a static wire size (no nested "
             "containers) small enough that MAX_CHUNK_TOKENS elements "
             "stay below 2**32 words"),
        # -- model configs --------------------------------------------------
        Rule("config-moe-topk", Severity.ERROR,
             "the MoE router's top-k never exceeds the expert count",
             "set moe_topk <= moe_experts"),
        Rule("config-layer-pattern", Severity.ERROR,
             "layer_pattern names a known layer plan",
             "use one of the ModelConfig.layer_kinds patterns"),
        Rule("config-head-grouping", Severity.ERROR,
             "KV head grouping divides evenly (GQA repeats n_heads/n_kv)",
             "pick n_kv dividing n_heads and, when head_dim is unset, "
             "n_heads dividing d_model"),
    ]
}


@dataclass(frozen=True)
class Finding:
    """One rule firing at one location."""

    rule: str
    severity: Severity
    location: str
    message: str
    hint: str

    def render(self) -> str:
        return (f"[{self.severity.name}] {self.rule} @ {self.location}: "
                f"{self.message} (fix: {self.hint})")


def finding(rule_id: str, location: str, message: str,
            hint: Optional[str] = None) -> Finding:
    """Build a Finding with severity + hint pulled from the catalog."""
    rule = RULES[rule_id]
    return Finding(rule_id, rule.severity, location, message,
                   hint if hint is not None else rule.hint)


@dataclass
class Report:
    """Aggregated findings across every analyzed target."""

    findings: List[Finding] = field(default_factory=list)
    targets: int = 0  # targets analyzed (for the summary line)

    def extend(self, fs: List[Finding]) -> List[Finding]:
        self.findings.extend(fs)
        return fs

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity is Severity.ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity is Severity.WARN]

    @property
    def clean(self) -> bool:
        """No ERROR and no WARN findings."""
        return not self.errors and not self.warnings

    def render(self) -> str:
        lines = [f.render() for f in sorted(
            self.findings, key=lambda f: (-int(f.severity), f.location)
        )]
        lines.append(
            f"{self.targets} targets analyzed: {len(self.errors)} errors, "
            f"{len(self.warnings)} warnings"
        )
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "targets": self.targets,
            "errors": len(self.errors),
            "warnings": len(self.warnings),
            "findings": [
                {
                    "rule": f.rule,
                    "severity": f.severity.name,
                    "location": f.location,
                    "message": f.message,
                    "hint": f.hint,
                }
                for f in self.findings
            ],
            "rules": {
                r.id: {
                    "severity": r.severity.name,
                    "proves": r.proves,
                    "hint": r.hint,
                }
                for r in RULES.values()
            },
        }


def assert_clean(fs: List[Finding], context: str) -> List[Finding]:
    """Raise ValueError on any ERROR finding (the ``analyze=True`` hook
    contract: fail with the rule's fix hint before any device work)."""
    errors = [f for f in fs if f.severity is Severity.ERROR]
    if errors:
        raise ValueError(
            f"{context}: static analysis found "
            f"{len(errors)} error(s):\n" +
            "\n".join("  " + f.render() for f in errors)
        )
    return fs
