"""The engine's plies and the autoreset (`selfplay/dual.dual_step_autoreset_ring`
-> `env/core`, `env/ring`, kernel B): the dual step's span less the
opponents' spans inside it, host milliseconds per update."""


def read(rec):
    s = rec["spans"]
    if rec["kind"] != "update" or "dual_step" not in s:
        return None
    return (s["dual_step"] - s.get("opponent", 0.0)) / rec["ops"] * 1e3
