"""The batched plane: ``repro_torch.launch.serve.serve_requests``.

One call hands the program every request wire of the call and gets the
response wires back: the host structure pass and the DES kernels, the
continuous batcher's prefill and decode steps, the bulk SER.  The fabric
and the streaming SER are bypassed."""
from __future__ import annotations

STREAMED = False


class Plane:
    def __init__(self, cell, cfg, params, device, traced: bool):
        w, mix = cell.workload, cell.mix
        self.kw = dict(max_new=int(mix["max_new"]), pad_to=int(mix["pad_to"]),
                       slots=int(w["slots"]), device=device)
        self.cfg, self.params = cfg, params
        #: the warm-up call: one wire runs the cell's own shapes (the admit
        #: prefill is always ``slots`` x ``pad_to``, a decode step ``slots``)
        self.warm_wires = 1

    def serve(self, wires, call):
        from repro_torch.launch.serve import serve_requests

        return serve_requests(self.params, self.cfg, wires, **self.kw)
