"""The opponents' moves (`train/ppo._opponent_policy`: the pool's greedy
slots and the league slot's Gumbel search, `search/gumbel`): the host
milliseconds per update of the spans around every call of the policy."""


def read(rec):
    if rec["kind"] != "update" or "opponent" not in rec["spans"]:
        return None
    return rec["spans"]["opponent"] / rec["ops"] * 1e3
