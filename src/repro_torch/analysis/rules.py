"""Shared primitive validation rules: runtime checks == analyzer findings.

These functions are the SINGLE source of truth for checks that used to be
duplicated across ``Fabric.__init__`` / ``Router.__init__`` (the
MAX_RANKS route-word budget), ``Fabric.send`` (the u8 ``list_level``
lane), and ``FabricConfig.__post_init__`` (the config invariants).  The
runtime call sites raise exactly the message a function here returns and
the analyzer wraps the same message in a :class:`~.findings.Finding`, so
the error a user hits at runtime and the finding ``python -m
repro.analysis`` reports are literally the same words — and each check is
tested once.

Import discipline: ``fabric/router.py`` and ``fabric/mailbox.py`` import
this module at module top, so it must be importable BEFORE
``repro.fabric`` finishes initializing — anything from the fabric package
is therefore imported lazily inside the functions (by call time the
packages are fully loaded).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .findings import Finding, finding

#: u8 budget of the frame header's ListLevel lane (``frames.HDR_LEVEL``)
MAX_LIST_LEVEL = 255


def max_ranks_error(n_ranks: int) -> Optional[str]:
    """Unified MAX_RANKS message (rule ``fabric-max-ranks``), raised
    verbatim by both ``Fabric.__init__`` and ``Router.__init__``."""
    from ..fabric.frames import MAX_RANKS

    if n_ranks <= MAX_RANKS:
        return None
    return (
        f"fabric of {n_ranks} ranks exceeds MAX_RANKS={MAX_RANKS}: the "
        f"route word's src field is a u7 lane (frames.py packs "
        f"adaptive:u1|src:u7|dst:u8|seq:u16), so ranks beyond {MAX_RANKS} "
        f"would silently alias rank (r % {MAX_RANKS}) and misdeliver "
        f"frames"
    )


def list_level_error(list_level) -> Optional[str]:
    """Unified ``list_level`` range message (rule ``fabric-list-level``),
    raised verbatim by ``Fabric.send``: the ListLevel header lane is
    u8-budgeted, and an out-of-range level would wrap silently and alias
    another tenant's QoS class (the router keys credit classes on
    ``level % n_classes``)."""
    if isinstance(list_level, (int, np.integer)) and not isinstance(
        list_level, bool
    ) and 0 <= int(list_level) <= MAX_LIST_LEVEL:
        return None
    return (
        f"list_level must be an int in [0, {MAX_LIST_LEVEL}], got "
        f"{list_level!r}"
    )


def fabric_config_findings(
    frame_phits: int,
    credits: int,
    routing: str,
    defect_after: int,
    qos_weights: Optional[Tuple[int, ...]],
    sizes: Optional[Sequence[int]] = None,
    location: str = "FabricConfig",
    *,
    arq: bool = False,
    retransmit_timeout: int = 8,
    max_retries: int = 4,
    arq_buffer: int = 1024,
    arq_level: int = 255,
    arq_skip_after: int = 0,
    suspect_after: Optional[int] = None,
) -> List[Finding]:
    """Every static finding derivable from FabricConfig fields alone.

    ``FabricConfig.__post_init__`` raises the first ERROR's message, so
    runtime construction and the analyzer agree word for word; WARN-level
    findings (quota floors, defection bounds — the latter only when the
    mesh ``sizes`` are known) surface exclusively through the analyzer.
    ``suspect_after`` is the serve-plane blackout-detection knob: it never
    lives on FabricConfig, but its consistency with the ARQ timeouts is a
    fabric property, so the rule lives here with the rest.
    """
    fs: List[Finding] = []
    if frame_phits < 1 or credits < 1:
        fs.append(finding(
            "fabric-config-positive", location,
            f"frame_phits/credits must be >= 1, got "
            f"{frame_phits}/{credits}",
        ))
    if routing not in ("shortest", "dimension"):
        fs.append(finding(
            "fabric-routing-mode", location,
            f"routing must be 'shortest' or 'dimension', got {routing!r}",
        ))
    if defect_after < 0:
        fs.append(finding(
            "fabric-defect-config", location,
            f"defect_after must be >= 0, got {defect_after}",
        ))
    if defect_after > 0 and routing == "dimension":
        fs.append(finding(
            "fabric-defect-config", location,
            "defect_after needs routing='shortest': only frames whose "
            "route word carries the adaptive bit may defect, and "
            "dimension-order frames never do",
        ))
    if qos_weights is not None:
        if len(qos_weights) < 1 or any(w < 1 for w in qos_weights):
            fs.append(finding(
                "fabric-qos-weights", location,
                f"qos_weights must be positive, got {qos_weights}",
            ))
        elif credits >= 1:
            if credits < len(qos_weights):
                fs.append(finding(
                    "fabric-credit-deadlock", location,
                    f"need credits >= qos classes so every class holds at "
                    f"least one credit, got credits={credits} for "
                    f"{len(qos_weights)} classes",
                ))
            else:
                # largest-remainder zero-quota classes: a class whose raw
                # share floors to 0 survives only by the >= 1 bump
                total = sum(qos_weights)
                floored = [
                    c for c, w in enumerate(qos_weights)
                    if math.floor(credits * w / total) == 0
                ]
                if floored:
                    fs.append(finding(
                        "fabric-qos-quota-floor", location,
                        f"classes {floored} earn a zero largest-remainder "
                        f"share of {credits} credits under weights "
                        f"{tuple(qos_weights)} and run on the 1-credit "
                        f"floor",
                    ))
    if (
        defect_after > 0 and routing == "shortest" and sizes
        and any(n > 1 and defect_after >= n for n in sizes)
    ):
        fs.append(finding(
            "fabric-defect-bound", location,
            f"defect_after={defect_after} is >= a ring size in "
            f"{tuple(sizes)}: a starved frame waits longer than riding "
            f"the whole ring the long way, and the scan bound inflates "
            f"past the dimension-order worst case",
        ))
    if arq:
        fs.extend(arq_config_findings(
            credits=credits,
            qos_weights=qos_weights,
            retransmit_timeout=retransmit_timeout,
            max_retries=max_retries,
            arq_buffer=arq_buffer,
            arq_level=arq_level,
            arq_skip_after=arq_skip_after,
            suspect_after=suspect_after,
            location=location,
        ))
    return fs


def arq_config_findings(
    *,
    credits: int = 4,
    qos_weights: Optional[Tuple[int, ...]] = None,
    retransmit_timeout: int = 8,
    max_retries: int = 4,
    arq_buffer: int = 1024,
    arq_level: int = 255,
    arq_skip_after: int = 0,
    suspect_after: Optional[int] = None,
    location: str = "FabricConfig",
) -> List[Finding]:
    """Static findings for the ARQ reliability layer (``arq=True``).

    Three properties, shared verbatim by ``FabricConfig.__post_init__``
    and the analyzer:

    * **seq-window ambiguity**: the per-(src, dst) retransmit buffer must
      stay strictly inside half the u16 seq window — with ``arq_buffer >=
      SEQ_MOD // 2`` a cumulative ACK can no longer tell "already
      delivered" from "half a window behind" and a retransmit may resolve
      to the wrong message bytes.
    * **control-class credit floor**: ACK/NACK control frames ride QoS
      class ``arq_level % len(qos_weights)``; if that class's
      weight-proportional share of the link credits floors to zero, bulk
      data can starve the very frames that un-starve it (recovery
      liveness depends on control traffic draining every step).
    * **timeout consistency**: the give-up/skip horizon and the serve
      plane's blackout detector must both sit ABOVE the retransmit
      timeout, or a healthy peer gets skipped/suspected before its first
      retransmit could possibly arrive.
    """
    from ..fabric.frames import SEQ_MOD

    fs: List[Finding] = []
    if retransmit_timeout < 1 or max_retries < 0 or arq_buffer < 1 \
            or arq_skip_after < 0:
        fs.append(finding(
            "fabric-arq-config", location,
            f"need retransmit_timeout >= 1, max_retries >= 0, "
            f"arq_buffer >= 1, arq_skip_after >= 0; got "
            f"retransmit_timeout={retransmit_timeout}, "
            f"max_retries={max_retries}, arq_buffer={arq_buffer}, "
            f"arq_skip_after={arq_skip_after}",
        ))
    lvl_err = list_level_error(arq_level)
    if lvl_err is not None:
        fs.append(finding(
            "fabric-arq-config", location, f"arq_level: {lvl_err}",
        ))
    if arq_buffer >= SEQ_MOD // 2:
        fs.append(finding(
            "fabric-arq-window", location,
            f"arq_buffer={arq_buffer} reaches half the u16 seq window "
            f"(SEQ_MOD//2={SEQ_MOD // 2}): cumulative ACKs become "
            f"ambiguous and a retransmit may alias a message half a "
            f"window away",
        ))
    if (
        qos_weights is not None and len(qos_weights) >= 1
        and all(w >= 1 for w in qos_weights) and credits >= len(qos_weights)
    ):
        cls = int(arq_level) % len(qos_weights)
        total = sum(qos_weights)
        if math.floor(credits * qos_weights[cls] / total) == 0:
            fs.append(finding(
                "fabric-arq-control-class", location,
                f"ARQ control class {cls} (arq_level={arq_level} % "
                f"{len(qos_weights)} classes) earns a zero "
                f"weight-proportional share of {credits} credits under "
                f"weights {tuple(qos_weights)}: ACK/NACK frames survive "
                f"only on the 1-credit floor bump while recovery "
                f"liveness depends on them",
            ))
    if arq_skip_after > 0 and arq_skip_after <= retransmit_timeout:
        fs.append(finding(
            "fabric-arq-timeout", location,
            f"arq_skip_after={arq_skip_after} must exceed "
            f"retransmit_timeout={retransmit_timeout}: the receiver "
            f"would skip past a gap before the sender's first "
            f"retransmit could arrive",
        ))
    if suspect_after is not None and suspect_after <= retransmit_timeout:
        fs.append(finding(
            "fabric-arq-timeout", location,
            f"suspect_after={suspect_after} must exceed "
            f"retransmit_timeout={retransmit_timeout}: a healthy shard "
            f"mid-retransmit would be declared suspect and its requests "
            f"re-placed for no fault",
        ))
    return fs
