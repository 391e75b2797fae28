"""The engine's plies and the autoreset (`selfplay/dual` -> `env/core`,
`env/ring`, kernel B): the host's own milliseconds per update in the
program's `engine.ply` and `engine.reset` spans of the rollout, their total
less the time they blocked on the device (`trace.sync`).  Read beside
`engine_self_ms.update` (synchronised wall time): close, the layer is bound
by the host issuing its work; far below, by the device."""

from benchmark import program_spans

PATHS = ("update/rollout/engine.ply", "update/rollout/engine.reset")


def read(rec):
    recs = program_spans.window(rec, "update") if rec["kind"] == "update" else None
    return None if recs is None else program_spans.host_ms(recs, PATHS)
