"""The rollout loop (`train/ppo.rollout`): its span's host milliseconds per
update over the traced window, with a synchronise at the span's ends."""


def read(rec):
    if rec["kind"] != "update" or "rollout" not in rec["spans"]:
        return None
    return rec["spans"]["rollout"] / rec["ops"] * 1e3
