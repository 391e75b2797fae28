"""The epochs (`train/ppo._ppo_epochs` -> `ppo_loss`, `train/optim`): their
span's host milliseconds per update."""


def read(rec):
    if rec["kind"] != "update" or "epochs" not in rec["spans"]:
        return None
    return rec["spans"]["epochs"] / rec["ops"] * 1e3
