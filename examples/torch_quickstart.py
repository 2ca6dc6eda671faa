"""Quickstart on the PyTorch/CUDA port: HGum end to end in two minutes.

The twin of ``examples/quickstart.py`` (same schema, message and figures),
on ``repro_torch``:

1. Define a message schema in the HGum IDL (paper Fig. 6).
2. Software-serialize a message (SW->HW).
3. Deserialize it with the cycle-accurate hardware DES FSM -> tagged tokens.
4. Deserialize the bulk payload with the port's DES kernels on the card
   (``repro_torch.kernels.decode_message_kernel``: the structure pass on
   the host, one CUDA launch per leaf); it prints which kernel each leaf
   took (B1 ``unpack_run`` aligned, dense or strided; B2 its general body;
   B3 ``unpack_gather``).
5. Loop a message through the HW->HW framed link.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the CUDA card unless given ``--device cpu`` (the kernels' plain
versions on the host); without a card and without ``--device cpu`` it
raises.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from repro_torch.core import (
    ClientSchema, DesFSM, Schema, SerFSM, build_plan, build_rom,
    lanes_to_int, ser_sw_to_hw, strip_for_ser,
    tokens_to_msg,
)
from repro_torch.device import DeviceLike, default_device
from repro_torch.kernels import decode_message_kernel, runs_from_plan, wire_to_u32
from repro_torch.kernels import phit_unpack

SCHEMA_JSON = {
    "Msg": [
        ["a", ["List", ["Array", ["Struct", "Tuple"]]]],
        ["b", ["Bytes", 1]],
    ],
    "Tuple": [["x", ["Bytes", 4]], ["y", ["Bytes", 8]]],
}
CLIENT_JSON = {  # paper Fig. 7
    "a.start": 1, "a.elem.start": 2, "a.elem.elem.x": 3,
    "a.elem.elem.y": 4, "a.elem.end": 5,
}
MSG = {"a": [[{"x": 17, "y": 34}, {"x": 51, "y": 68}]], "b": 9}


def des_route(plan, path: str) -> str:
    """The DES kernel ``decode_message_kernel`` takes for ``path``: B1
    (aligned run; dense where the rows abut, else strided), B2 (a run at
    any byte offset) or B3 (a gather)."""
    run = runs_from_plan(plan, path)
    if run is None:
        return "B3 unpack_gather"
    base, stride = run
    if base % 4 or stride % 4:
        return "B2 unpack_run_general"
    dense = stride // 4 == (plan.nbytes[path] + 3) // 4
    return f"B1 unpack_run_aligned ({'dense' if dense else 'strided'})"


def kernel_decode(schema, msg, wire: bytes, device: DeviceLike) -> Dict:
    """Step 4: the structure pass on the host, the payload pass through the
    DES kernels on ``device``.  Returns the decoded ``a[.][.].x`` values,
    each leaf's kernel and the kernel launches the decode made (all 0 on
    the CPU, where the wrappers take the plain versions)."""
    dev = default_device(device)
    plan = build_plan(schema, msg)
    before = dict(phit_unpack.LAUNCHES)
    dec = decode_message_kernel(wire_to_u32(wire, dev), plan)
    launches = {k: v - before[k] for k, v in phit_unpack.LAUNCHES.items()}
    xs = lanes_to_int(dec["a.elem.elem.x"].cpu().numpy(), 4)
    return {"xs": [int(v) for v in xs],
            "routes": {p: des_route(plan, p) for p in plan.offsets},
            "launches": launches}


def quickstart(device: DeviceLike = None) -> Dict:
    """Steps 1-5; returns every figure the script prints."""
    schema = Schema.from_json(SCHEMA_JSON)
    client = ClientSchema.from_json(CLIENT_JSON)
    rom = build_rom(schema, client)
    wire = ser_sw_to_hw(schema, MSG)
    res = DesFSM(rom, "sw2hw").run(wire)
    assert tokens_to_msg(schema, res.tokens, client) == MSG
    dec = kernel_decode(schema, MSG, wire, device)
    assert dec["xs"] == [17, 51]
    ser = SerFSM(rom, "hw2hw", frame_phits=4).run(strip_for_ser(res.tokens))
    back = DesFSM(rom, "hw2hw").run(ser.wire)
    assert [(t.kind, t.value) for t in back.tokens] == [
        (t.kind, t.value) for t in res.tokens
    ]
    return {
        "rom": rom.describe(), "wire": wire, "des_cycles": res.cycles,
        "tokens": [str(t) for t in res.tokens], **dec,
        "frames": ser.frames, "hw_wire_bytes": len(ser.wire),
        "ser_cycles": ser.cycles, "des_hw_cycles": back.cycles,
    }


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    out = quickstart(dev)
    print("schema ROM:")
    print(out["rom"])
    print(f"\nwire = {len(out['wire'])} bytes: {out['wire'].hex()}")
    print(f"\nDES: {out['des_cycles']} cycles -> {len(out['tokens'])} tokens")
    for t in out["tokens"]:
        print("  ", t)
    print(f"\nkernel decode on {dev} of a[.][.].x -> {out['xs']}")
    for p, route in out["routes"].items():
        print(f"   {p}: {route}")
    launched = {k: n for k, n in out["launches"].items() if n}
    print(f"   kernel launches: {launched if dev.type == 'cuda' else 'none (plain versions on the host)'}")
    if dev.type == "cuda":
        assert launched, "the decode launched no DES kernel on the card"
    print(f"\nHW->HW: {out['frames']} frames, {out['hw_wire_bytes']} wire bytes, "
          f"SER {out['ser_cycles']} cycles, DES {out['des_hw_cycles']} cycles — loopback OK")
    return out


if __name__ == "__main__":
    main()
