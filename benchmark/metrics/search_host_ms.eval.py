"""The eval bot's Gumbel search (`search/gumbel`): the host's own
milliseconds per eval in the program's `search` spans of the eval's turns,
their total less the time they blocked on the device (`trace.sync`).  Read
beside the eval's median time and `device_idle.eval`."""

from benchmark import program_spans

PATHS = ("eval/eval.turn/search",)


def read(rec):
    recs = program_spans.window(rec, "eval") if rec["kind"] == "eval" else None
    return None if recs is None else program_spans.host_ms(recs, PATHS)
