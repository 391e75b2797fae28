"""Search policies on the batched rules engine: flat Monte-Carlo, PUCT tree
search, Gumbel sequential halving, and the censored (information-set)
variants of the first and the last.  Counterpart of `splendax/search`."""

from .gumbel import gumbel_search_policy  # noqa: F401
from .ismc import (  # noqa: F401
    censored_gumbel_policy,
    censored_mc_policy,
    censored_mc_q,
    determinize,
)
from .mc import mc_search_policy, mc_search_q  # noqa: F401
from .uct import uct_search_policy  # noqa: F401
