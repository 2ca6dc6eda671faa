"""The streaming plane: ``repro_torch.launch.serve.serve_requests_streaming``.

The ingress (rank 0) places the call's request wires on ``n_shards``
serving shards over the program's own default fabric (ARQ on), each shard
batches and decodes its share, and every decode tick's tokens (and, with
``logprobs``, their logprobs as a second typed stream) ride the fabric
back as chunk bursts.  The client times each token as it reaches the
ingress (``on_token``)."""
from __future__ import annotations

import time

STREAMED = True


class Plane:
    def __init__(self, cell, cfg, params, device, traced: bool):
        w, mix = cell.workload, cell.mix
        args = w["plane_args"]
        self.kw = dict(max_new=int(mix["max_new"]), pad_to=int(mix["pad_to"]),
                       slots=int(w["slots"]), n_shards=int(args["n_shards"]),
                       overlap=bool(args["overlap"]), logprobs=bool(args["logprobs"]),
                       device=device)
        self.cfg, self.params, self.traced = cfg, params, traced
        #: one wire per shard, so the warm-up runs every shard's batcher
        self.warm_wires = int(args["n_shards"])

    def serve(self, wires, call):
        from repro_torch.launch.serve import serve_requests_streaming

        toks, times = call.stream_tokens, call.token_times

        def on_token(m, j, step, tok):
            t = time.perf_counter()
            toks.setdefault((m, j), []).append((step, int(tok)))
            times.setdefault((m, j), []).append(t)

        trace = spans = None
        if self.traced:
            from repro_torch.obs import SpanTracker, TraceRecorder

            trace = TraceRecorder()
            spans = SpanTracker(trace)
            call.obs_trace, call.spans = trace, spans
        return serve_requests_streaming(self.params, self.cfg, wires, on_token=on_token,
                                        trace=trace, spans=spans, **self.kw)
