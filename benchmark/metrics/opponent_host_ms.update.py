"""The opponents' moves (`selfplay/pool.pool_greedy_policy` and the league
slot's Gumbel search, `search/gumbel`): the host's own milliseconds per
update in the program's `pool` and `search` spans of the rollout, their total
less the time they blocked on the device (`trace.sync`).  Read beside
`opponent_ms.update` (synchronised wall time)."""

from benchmark import program_spans

PATHS = ("update/rollout/pool", "update/rollout/search")


def read(rec):
    recs = program_spans.window(rec, "update") if rec["kind"] == "update" else None
    return None if recs is None else program_spans.host_ms(recs, PATHS)
