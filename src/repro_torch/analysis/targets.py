"""Shipped analysis targets: everything ``python -m repro_torch.analysis``
proves safe.

Four registries — schemas (the framework's own messages + the paper's
Fig. 6/7 example), fabric configs (the serve default + every bench
configuration), demand matrices (the deterministic ``bench_fabric``
workloads), and the shipped model configs.  Each entry carries the
location string findings anchor to, so a CI failure names the exact
artifact that regressed.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core.idl import ClientSchema, Schema

#: benchmarks/bench_fabric.py geometry (the oracle workloads)
BENCH_RANKS = 8
BENCH_FRAME_PHITS = 16
BENCH_PAYLOAD_BYTES = 4096
BENCH_N_MSGS = 8

# The paper's Fig. 6 schema + Fig. 7 client schema (examples/quickstart.py)
QUICKSTART_SCHEMA_JSON = {
    "Msg": [
        ["a", ["List", ["Array", ["Struct", "Tuple"]]]],
        ["b", ["Bytes", 1]],
    ],
    "Tuple": [
        ["x", ["Bytes", 4]],
        ["y", ["Bytes", 8]],
    ],
}
QUICKSTART_CLIENT_JSON = {
    "a.start": 1,
    "a.elem.start": 2,
    "a.elem.elem.x": 3,
    "a.elem.elem.y": 4,
    "a.elem.end": 5,
}


def schema_targets() -> List[Tuple[
    str, Schema, Optional[ClientSchema], Optional[Dict[str, int]]
]]:
    """(location, schema, client, caps) for every shipped schema."""
    from ..data.schemas import (
        batch_client_schema,
        batch_schema,
        request_schema,
        response_schema,
    )

    return [
        ("data.batch_schema", batch_schema(128), batch_client_schema(),
         {"rows": 64, "rows.elem.tokens": 128, "rows.elem.segids": 128}),
        ("data.request_schema", request_schema(), None,
         {"prompts": 64, "prompts.elem.tokens": 4096}),
        ("data.response_schema", response_schema(), None, None),
        ("examples.quickstart",
         Schema.from_json(QUICKSTART_SCHEMA_JSON),
         ClientSchema.from_json(QUICKSTART_CLIENT_JSON), None),
    ]


def stream_targets() -> List[Tuple[str, Schema]]:
    """(location, schema) for every shipped ``Stream<T>`` declaration —
    the generated token codec and the logprob side stream (both live in
    ``stream/chunks.py`` as pure schema JSON)."""
    from ..stream.chunks import (
        LOGPROB_STREAM_SCHEMA_JSON,
        TOKEN_STREAM_SCHEMA_JSON,
    )

    return [
        ("stream.token_stream",
         Schema.from_json(TOKEN_STREAM_SCHEMA_JSON)),
        ("stream.logprob_stream",
         Schema.from_json(LOGPROB_STREAM_SCHEMA_JSON)),
    ]


def fabric_targets() -> List[Tuple[str, dict]]:
    """(location, analyze_fabric_values kwargs) for every shipped fabric
    configuration: the serve default, the bench_fabric sweeps, and the
    bench_stream QoS classes."""
    sizes = (BENCH_RANKS,)
    targets: List[Tuple[str, dict]] = [
        ("launch.default_serve_fabric", dict(
            frame_phits=16, credits=4, routing="shortest", sizes=sizes,
            arq=True, suspect_after=24,
        )),
        ("bench_fabric.faulty_link.arq", dict(
            frame_phits=BENCH_FRAME_PHITS, credits=8, routing="shortest",
            sizes=sizes, arq=True,
        )),
        ("bench_fabric.dimension", dict(
            frame_phits=BENCH_FRAME_PHITS, credits=8, routing="dimension",
            sizes=sizes,
        )),
        ("bench_fabric.starved_link.defect", dict(
            frame_phits=BENCH_FRAME_PHITS, credits=2, routing="shortest",
            defect_after=2, sizes=sizes,
        )),
    ]
    for credits in (1, 2, 4, 8, 16):
        targets.append((f"bench_fabric.credits[{credits}]", dict(
            frame_phits=BENCH_FRAME_PHITS, credits=credits,
            routing="shortest", sizes=sizes,
        )))
    for weights in ((1, 1), (3, 1), (1, 3)):
        targets.append((f"bench_stream.qos{weights}", dict(
            frame_phits=2, credits=4, qos_weights=weights, sizes=sizes,
        )))
    return targets


def _bench_counts(n_msgs: int, payload: int) -> int:
    from ..fabric.frames import frame_capacity

    return n_msgs * frame_capacity(payload, BENCH_FRAME_PHITS)


def demand_targets() -> List[Tuple[
    str, Tuple[int, ...], dict,
    Sequence[int], Sequence[int], Sequence[int], Optional[Sequence[int]]
]]:
    """(location, sizes, config kwargs, srcs, dsts, counts, levels) —
    the deterministic ``bench_fabric`` workloads, with counts in frames
    exactly as the mailbox will inject them (terminator included)."""
    sizes = (BENCH_RANKS,)
    per_msg = _bench_counts(1, BENCH_PAYLOAD_BYTES)
    base = dict(frame_phits=BENCH_FRAME_PHITS, credits=8,
                routing="shortest")
    out = []
    # bit-exactness workload: every rank sends one payload to +1
    out.append((
        "bench_fabric.neighbor", sizes, base,
        list(range(BENCH_RANKS)),
        [(r + 1) % BENCH_RANKS for r in range(BENCH_RANKS)],
        [per_msg] * BENCH_RANKS, None,
    ))
    # hop sweep: N_MSGS payloads 0 -> dst for every non-zero dst
    for dst in range(1, BENCH_RANKS):
        out.append((
            f"bench_fabric.hops[dst={dst}]", sizes, base,
            [0] * BENCH_N_MSGS, [dst] * BENCH_N_MSGS,
            [per_msg] * BENCH_N_MSGS, None,
        ))
    # credit sweep: N_MSGS payloads 0 -> 4 under each budget
    for credits in (1, 2, 4, 8, 16):
        out.append((
            f"bench_fabric.credits[{credits}]", sizes,
            dict(base, credits=credits),
            [0] * BENCH_N_MSGS, [4] * BENCH_N_MSGS,
            [per_msg] * BENCH_N_MSGS, None,
        ))
    # starved +1 link: heavy 0 -> 1 and light 0 -> 4, defection off/on
    starved = _bench_counts(1, 1536)
    for defect in (0, 2):
        out.append((
            f"bench_fabric.starved[defect={defect}]", sizes,
            dict(frame_phits=BENCH_FRAME_PHITS, credits=2,
                 routing="shortest", defect_after=defect),
            [0] * 12, [1] * 6 + [4] * 6, [starved] * 12,
            [2] * 6 + [1] * 6,
        ))
    return out


def model_config_targets() -> List[Tuple[str, object]]:
    """(location, ModelConfig) for every registered architecture."""
    from ..configs import all_archs, get_config

    return [(f"configs.{name}", get_config(name)) for name in all_archs()]


def total_targets() -> int:
    return (len(schema_targets()) + len(stream_targets())
            + len(fabric_targets()) + len(demand_targets())
            + len(model_config_targets()))
