"""The update step's blocking reads (`train/ppo.update_step`): the program's
`sync.<site>` counters (`splendax_torch.trace.sync`: device-to-host reads,
pageable host-to-device copies and scalar writes into device tensors, each
site counted once a call) summed over the window's updates, per update."""

from benchmark import program_spans


def read(rec):
    recs = program_spans.window(rec, "update") if rec["kind"] == "update" else None
    return None if recs is None else program_spans.syncs(recs)
