"""Fused masked actor-critic forward.

Counterpart of the TPU kernel `splendax/ops/fused_actor_critic.py`: both MLPs
(297 -> H -> H -> 45 actor, 297 -> H -> H -> 1 critic, tanh after the first
two layers) and the masked-logits select in one pass.  On a CUDA tensor
`fused_masked_forward` launches a hand-written kernel, chosen by the hidden
width alone (`route`): up to 768 the `wgmma` route, above it the `wide`
route, with no upper bound on the width.  Both live in
`csrc/fused_actor_critic_wgmma.cu` (wgmma fed by TMA, 3xTF32 products on
the tensor cores) and launch its weight preparation first.  The `wgmma`
route keeps the first hidden layer of a 64-row tile in shared memory and
has two modes, chosen by `wgmma_mode(B, H)`: tile mode (a block per 64-row
tile does every column) and, at small B, cluster mode (a cluster of blocks
per tile and head splits the hidden columns).  The `wide` route stores the
first hidden layer to a scratch in device memory and streams it back by
TMA, a block per (128 columns, 128-row tile, head) in each layer (pass
mode) or, where those would leave half the SMs idle, per (64 columns,
tile, head) (half mode; `wide_mode(B, H, with_value)`); B is cut into calls
of at most `WIDE_MAX_ROWS` rows.  All sum in one order, so a row's outputs
are the same bits in every mode and at every B.  On a CPU
tensor it runs `fused_masked_forward_plain`, the same function in plain
PyTorch.  `fused_value_forward` runs the critic alone, for callers that
would drop the logits (a search's leaves, the bootstrap): the same kernels
on one head, whose value has the bits of the call with both heads.  The
kernels are held within rtol/atol 1e-5 of the plain version, which
computes in the weights' dtype: on the committed nets the plain float32
version is itself that far from the exact forward, so float64 weights give
the reference.

Counters (in `splendax_torch.trace`'s registry, read here as module
attributes): `launches` counts forwards that launched a kernel (one each,
`kernel_a.launches`), `launches_by_route` splits them by route
(`kernel_a.route.<route>`), `launches_by_mode` splits the `wgmma` route's by
mode (`kernel_a.mode.<mode>`), `launches_by_wide_mode` the `wide` route's
(`kernel_a.wide_mode.<mode>`), `critic_launches` counts the forwards of
the critic alone among them (`kernel_a.heads.critic`), and `prep_launches`
counts the launches of the weight preparation of the `wgmma` and `wide`
routes (`kernel_a.prep`); `launch_counts()` reads them all.

`weights` is the list of the 12 weight and bias tensors in the JAX package's
layout, [in, out]: aw0 ab0 aw1 ab1 aw2 ab2 cw0 cb0 cw1 cb1 cw2 cb2
(`models.actor_critic.kernel_weights` builds it), or a `PreparedWeights`
handle of them.  A plain list is prepared again by every forward on the
card; a handle keeps its preparation until one of the weights it read is
written (their version counters move), so a forward pays for the
preparation once per weight version.  Whoever owns the weights builds the
handle: the opponent pool (one a slot), the eval policies, the search
contexts, the host policies.
"""

from __future__ import annotations

import copy
import ctypes
import functools

import torch

from .. import trace
from . import _build

OBS_DIM = 297
ACT_DIM = 45
BIG_NEG = -1e9
WGMMA_MAX_HIDDEN = 768  # the widest first hidden layer the wgmma kernel's 64-row tile holds
K1_PAD = 304  # OBS_DIM padded to a multiple of 8
ROWS = 64  # the wgmma kernel's row tile
PASS_COLUMNS = 128  # hidden columns of one pass of the wgmma kernel
PORTABLE_CLUSTER = 8  # the most blocks a cluster may have without opting out
# The wgmma route's cluster mode up to this many rows, tile mode above:
# where the split stops paying on an H100 at H = 768 (chip_smoke.py times
# both modes at every B of the main path).
CLUSTER_MAX_ROWS = 4096
# The wide route's rows a launch: its scratch (`wide_scratch_floats`) is
# sized for this many rows at most, whatever B.
WIDE_MAX_ROWS = 32768
WIDE_ROWS = 128  # the wide route's row tile: two consumer groups of 64 rows
# The wide route's half mode while pass mode would launch at most this many
# blocks a layer: half the 132 SMs of an H100 SXM, one block each, so that
# half mode's twice as many still run in one wave (see `wide_mode`).
WIDE_HALF_MAX_BLOCKS = 66
WIDE_OUT_ROWS = 8  # rows of a block of the wide route's output kernel
WIDE_HEAD_PAD = 48  # the wide route's partial logits a row: 45 padded to six n-tiles of 8

ROUTES = ("wgmma", "wide")
MODES = {"wgmma": ("tile", "cluster"), "wide": ("pass", "half")}


def route(H: int) -> str:
    """The kernel a forward at hidden width H takes on the card: never a
    function of the batch, so a row's outputs do not depend on how the rows
    are split into calls.  "wgmma" while a 64-row tile's first hidden layer
    fits a block's shared memory, "wide" above, at any width."""
    return "wgmma" if H <= WGMMA_MAX_HIDDEN else "wide"


def wgmma_mode(B: int, H: int) -> str:
    """The `wgmma` route's mode for B rows at hidden width H: "cluster" (a
    cluster of `column_groups(H)` blocks per 64-row tile and head, one pass
    of 128 hidden columns each) up to `CLUSTER_MAX_ROWS` rows, where tile
    mode's few blocks would each take every pass in turn while most SMs
    idle, else "tile" (a block per tile).  The modes sum in the same order,
    so the choice changes no bit."""
    return "cluster" if B <= CLUSTER_MAX_ROWS else "tile"


def column_groups(H: int) -> int:
    """The blocks of a cluster-mode cluster: one per pass of 128 hidden
    columns."""
    return -(-H // PASS_COLUMNS)


def heads(with_value: bool, actor: bool = True) -> int:
    """The heads a forward computes: the actor unless `actor` is False
    (the critic alone), the critic with `with_value`."""
    return int(actor) + int(with_value)


def launch_shape(B: int, H: int, with_value: bool, mode: str, actor: bool = True):
    """(grid, cluster) of the `wgmma` kernel's launch, as the C side forms
    them: tile mode one block per 64-row tile; cluster mode one per tile,
    pass and head, a cluster over the passes of one tile and head."""
    tiles = -(-B // ROWS)
    if mode == "tile":
        return (tiles, 1, 1), (1, 1, 1)
    g = column_groups(H)
    return (tiles, g, heads(with_value, actor)), (1, g, 1)


def wide_chunks(B: int) -> list[tuple[int, int]]:
    """(first row, rows) of each launch of the wide route for B rows."""
    return [(c, min(WIDE_MAX_ROWS, B - c)) for c in range(0, B, WIDE_MAX_ROWS)]


def wide_scratch_floats(B: int, H: int, with_value: bool, actor: bool = True) -> int:
    """Floats of the wide route's scratch for a launch of B rows, as the C
    side lays it out: h1 [heads, B, pad16(H)] in f32, then, with the actor,
    the partial logits [passes, 2 groups of 64 columns, B, 48] and, with the
    value, the partial values [passes, 2, B]."""
    passes = column_groups(H)
    return B * (heads(with_value, actor) * pad16(H) + (passes * 2 * WIDE_HEAD_PAD if actor else 0)
                + (passes * 2 if with_value else 0))


def wide_mode(B: int, H: int, with_value: bool) -> str:
    """The `wide` route's mode for B rows at hidden width H: "pass" (a block
    per 128 hidden columns of a 128-row tile and head, so each weight stage
    serves twice the products) unless its blocks would leave half the SMs
    idle (at most `WIDE_HALF_MAX_BLOCKS` a layer), then "half" (a block per
    64 columns: twice the blocks, in one wave).  An H100 measured the split
    at H = 1024 and 1280 (scripts/torch_kernel_a_probe.py --wide).  The
    modes sum in the same order, so the choice changes no bit."""
    blocks = column_groups(H) * -(-min(B, WIDE_MAX_ROWS) // WIDE_ROWS) * (2 if with_value else 1)
    return "half" if blocks <= WIDE_HALF_MAX_BLOCKS else "pass"


def wide_launch_shape(B: int, H: int, with_value: bool, mode: str, actor: bool = True) -> dict:
    """The grids of a wide-route launch of B rows (one chunk) in `mode`, as
    the C side forms them: layer 1 and layer 2 a block per (128 or 64
    columns, 128-row tile, head), no cluster; the outputs a block per
    WIDE_OUT_ROWS rows."""
    blocks = column_groups(H) * (2 if mode == "half" else 1)
    layer = (blocks, -(-B // WIDE_ROWS), heads(with_value, actor))
    return {"layers": layer, "heads": (-(-B // WIDE_OUT_ROWS), 1, 1)}


def __getattr__(name: str):
    """The launch counters, read from `splendax_torch.trace`."""
    if name == "launches":
        return trace.counter("kernel_a.launches")
    if name == "prep_launches":
        return trace.counter("kernel_a.prep")
    if name == "critic_launches":
        return trace.counter("kernel_a.heads.critic")
    if name == "launches_by_route":
        return {r: trace.counter("kernel_a.route." + r) for r in ROUTES}
    if name == "launches_by_mode":
        return {m: trace.counter("kernel_a.mode." + m) for m in MODES["wgmma"]}
    if name == "launches_by_wide_mode":
        return {m: trace.counter("kernel_a.wide_mode." + m) for m in MODES["wide"]}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def launch_counts() -> dict:
    """Every counter of this module, by the names chip_smoke.py reports."""
    c = trace.counter
    return {"fused_actor_critic": c("kernel_a.launches"),
            **{f"fused_actor_critic_{r}": c("kernel_a.route." + r) for r in ROUTES},
            **{f"fused_actor_critic_{m}": c("kernel_a.mode." + m) for m in MODES["wgmma"]},
            **{f"fused_actor_critic_wide_{m}": c("kernel_a.wide_mode." + m)
               for m in MODES["wide"]},
            "fused_actor_critic_prep": c("kernel_a.prep"),
            "fused_actor_critic_critic_only": c("kernel_a.heads.critic")}


def pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as `cvt.rna.tf32.f32` does: to nearest, ties away
    from zero, 10 explicit mantissa bits."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def prepared_layout(H: int) -> list[tuple[int, int, int]]:
    """(offset, HP, KP) in floats of aw0, aw1, cw0 and cw1 in the prepared
    buffer, each [2, HP, KP] (hi then lo, output-major, K contiguous; HP is H
    padded to a multiple of 8, KP 297 padded to 304 for the first layers and
    H padded to a multiple of 16 for the second, whole chunks of two k-steps
    of 8)."""
    HP, KH = pad8(H), pad16(H)
    a, b = 2 * HP * K1_PAD, 2 * HP * KH
    return [(0, HP, K1_PAD), (a, HP, KH), (a + b, HP, K1_PAD), (2 * a + b, HP, KH)]


def prepared_floats(H: int) -> int:
    return 2 * (2 * pad8(H) * K1_PAD + 2 * pad8(H) * pad16(H))


def prepare_weights_plain(weights, with_value: bool = True) -> torch.Tensor:
    """The `wgmma` route's weight preparation in plain PyTorch: aw0, aw1 (and
    cw0, cw1 with `with_value`; zeros without) transposed to [out, in], split
    into hi = tf32(w) and lo = tf32(w - hi), zero-padded, as one flat
    float32 buffer in the layout of `prepared_layout`."""
    H = weights[0].shape[1]
    out = torch.zeros(prepared_floats(H), dtype=torch.float32, device=weights[0].device)
    for (o, hp, kp), i in zip(prepared_layout(H), (0, 2, 6, 8)):
        if i >= 6 and not with_value:
            continue
        w = weights[i].to(torch.float32).t()
        hi = tf32(w)
        m = out[o:o + 2 * hp * kp].view(2, hp, kp)
        m[0, :w.shape[0], :w.shape[1]] = hi
        m[1, :w.shape[0], :w.shape[1]] = tf32(w - hi)
    return out


# The weights a preparation reads: aw0, aw1, cw0, cw1.
PREPARED_INDICES = (0, 2, 6, 8)


def read_versions(weights) -> tuple:
    """The version counters of the four weights a preparation reads.  Every
    in-place write to a tensor moves its counter, and a view shares its
    base's: a write through any view of the same base moves it too."""
    return tuple(weights[i]._version for i in PREPARED_INDICES)


class PreparedWeights(tuple):
    """Kernel A's 12 weights with their preparation, made once per weight
    version.  A tuple of the 12 tensors, so it reads as the plain list does;
    it holds them, so their storage cannot be reused under it.  Beside them
    it keeps the prepared buffer and the version counters of the four
    weights that buffer was made from (`read_versions`).

    Every forward on the card takes `buffer()`, which prepares again, and
    counts it in `preparations`, whenever one of those counters differs from
    the recorded one: no in-place write to the weights (`copy_`, an
    optimizer's `_foreach_` step, a write through another view of the same
    base) leaves a forward on a stale buffer.  The buffer is prepared with
    the critic and serves the forwards without it too, which read only the
    actor's half: those bits do not depend on `with_value`.

    The preparation runs on the current stream.  A forward on another stream
    waits for it and marks the buffer as in use there.  A copy (`deepcopy`)
    holds copies of the weights and keeps the preparation only where it was
    current; a pickled handle comes back unprepared."""

    def __new__(cls, weights):
        self = super().__new__(cls, weights)
        if len(self) != 12:
            raise ValueError("weights must hold 12 tensors")
        self._buffer = None
        self._versions = None
        self._ready = None  # (stream, event) of the preparation on the card
        self.preparations = 0
        return self

    def stale(self) -> bool:
        """True if the next forward prepares: the handle was never prepared,
        or one of the weights it read was written since."""
        return self._buffer is None or self._versions != read_versions(self)

    def buffer(self, lib=None) -> torch.Tensor:
        """The prepared weights (`prepare_weights` with the critic), prepared
        again first if `stale()`; `lib` as `prepare_weights` takes it."""
        if self.stale():
            versions = read_versions(self)
            self._buffer = prepare_weights(self, True, lib)
            self._versions = versions
            self.preparations += 1
            self._mark_ready()
        elif self._ready is not None:
            stream, event = self._ready
            here = torch.cuda.current_stream(self._buffer.device)
            if here != stream:
                here.wait_event(event)
                self._buffer.record_stream(here)
        return self._buffer

    @property
    def prepared_bytes(self) -> int:
        """Bytes of the prepared buffer this handle holds (0 before its
        first preparation)."""
        return 0 if self._buffer is None else 4 * self._buffer.numel()

    def carry(self, before: tuple) -> None:
        """Keep the preparation across a write that left this handle's weights
        as they were but moved their counters (a write to another slot of
        the same stacked tensors): if the handle was current at `before`,
        the counters just before that write, record them as they are now.
        A handle that was stale before stays stale."""
        if self._buffer is not None and self._versions == before:
            self._versions = read_versions(self)

    def take_preparation(self, other: "PreparedWeights", memo=None) -> None:
        """Take a copy of `other`'s preparation, where this handle's weights
        are copies of `other`'s made just now; nothing if `other` was
        stale."""
        if other.stale():
            return
        self._buffer = copy.deepcopy(other._buffer, memo)
        self._versions = read_versions(self)
        self._mark_ready()

    def _mark_ready(self) -> None:
        self._ready = None
        if self._buffer.is_cuda:
            stream = torch.cuda.current_stream(self._buffer.device)
            event = torch.cuda.Event()
            event.record(stream)
            self._ready = (stream, event)

    def __deepcopy__(self, memo):
        out = PreparedWeights(copy.deepcopy(tuple(self), memo))
        out.take_preparation(self, memo)
        return out

    def __reduce__(self):
        return PreparedWeights, (tuple(self),)


def masked_logits(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Illegal actions -> -1e9; rows with no legal action left unmasked."""
    any_legal = mask.any(-1, keepdim=True)
    return torch.where(mask | ~any_legal, logits, BIG_NEG)


def fused_value_forward_plain(weights, obs):
    """The critic alone in plain PyTorch, in the weights' dtype: the value
    of `fused_masked_forward_plain`, bit for bit."""
    cw0, cb0, cw1, cb1, cw2, cb2 = weights[6:]
    x = obs.to(cw0.dtype)
    v = torch.tanh(x @ cw0 + cb0)
    v = torch.tanh(v @ cw1 + cb1)
    return (v @ cw2 + cb2)[:, 0]


def fused_masked_forward_plain(weights, obs, mask, with_value: bool = True):
    """The forward in plain PyTorch, in the weights' dtype: float32 as the
    kernel takes them, or float64 for a reference closer to exact."""
    aw0, ab0, aw1, ab1, aw2, ab2 = weights[:6]
    x = obs.to(aw0.dtype)
    h = torch.tanh(x @ aw0 + ab0)
    h = torch.tanh(h @ aw1 + ab1)
    logits = masked_logits(h @ aw2 + ab2, mask)
    return logits, (fused_value_forward_plain(weights, obs) if with_value else None)


SOURCE = "fused_actor_critic_wgmma"  # both routes' library


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares the C interface of `lib`, built from `csrc/<SOURCE>.cu`
    (with any probe switches), and returns it."""
    p, i, w = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)
    fns = [(lib.fused_actor_critic_wgmma_prepare, [w, i, i, p, p]),
           (lib.fused_actor_critic_wgmma_forward, [p, p, i, i, w, p, p, p, i, p]),
           (lib.fused_actor_critic_wide_forward,
            [p, p, i, i, w, p, p, ctypes.c_longlong, p, p, i, p]),
           (lib.fused_actor_critic_wgmma_max_clusters, [i, ctypes.POINTER(i)])]
    for fn, argtypes in fns:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load(SOURCE))


def _ptrs(weights):
    return (ctypes.c_void_p * 12)(*[w.data_ptr() for w in weights])


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def prepare_weights(weights, with_value: bool = True, lib=None) -> torch.Tensor:
    """The prepared weights of the `wgmma` and `wide` routes, at any width:
    on a CUDA tensor one launch of the preparation kernel (counted in
    `prep_launches`) from `lib` (the library's own build unless given one),
    on a CPU tensor `prepare_weights_plain`."""
    if weights[0].device.type == "cpu":
        return prepare_weights_plain(weights, with_value)
    H = weights[0].shape[1]
    for i, w in enumerate(weights):
        if w.device != weights[0].device or w.dtype != torch.float32 or not w.is_contiguous():
            raise ValueError(f"prepare_weights: weights[{i}] must be contiguous float32 on "
                             f"{weights[0].device}")
    prepared = torch.empty(prepared_floats(H), dtype=torch.float32, device=weights[0].device)
    lib = _lib() if lib is None else lib
    err = lib.fused_actor_critic_wgmma_prepare(
        _ptrs(weights), H, int(with_value), prepared.data_ptr(), _stream(prepared))
    if err != 0:
        raise RuntimeError(f"fused_actor_critic weight preparation failed: CUDA error {err}")
    trace.count("kernel_a.prep")
    return prepared


def _check(weights, obs, mask):
    """The hidden width of checked inputs; `mask` None for the critic
    alone."""
    dev = obs.device
    if obs.dtype != torch.int32 or obs.dim() != 2 or obs.shape[1] != OBS_DIM:
        raise ValueError(f"obs must be int32 [B, {OBS_DIM}], got {obs.dtype} {tuple(obs.shape)}")
    if mask is not None and (mask.dtype != torch.bool
                             or tuple(mask.shape) != (obs.shape[0], ACT_DIM)):
        raise ValueError(f"mask must be bool [B, {ACT_DIM}], got {mask.dtype} {tuple(mask.shape)}")
    if len(weights) != 12:
        raise ValueError("weights must hold 12 tensors")
    H = weights[0].shape[1]
    if H < 1:
        raise ValueError(f"hidden width {H} below 1")
    shapes = [(OBS_DIM, H), (H,), (H, H), (H,), (H, ACT_DIM), (ACT_DIM,),
              (OBS_DIM, H), (H,), (H, H), (H,), (H, 1), (1,)]
    for i, (w, s) in enumerate(zip(weights, shapes)):
        if tuple(w.shape) != s or w.dtype != torch.float32 or w.device != dev:
            raise ValueError(f"weights[{i}] must be float32 {s} on {dev}, got "
                             f"{w.dtype} {tuple(w.shape)} on {w.device}")
    tensors = [("obs", obs)] + ([("mask", mask)] if mask is not None else [])
    for name, t in tensors + [(f"weights[{i}]", w) for i, w in enumerate(weights)]:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    return H


def fused_masked_forward(weights, obs: torch.Tensor, mask: torch.Tensor, with_value: bool = True):
    """(weights, int32 obs [B, 297], bool mask [B, 45]) -> (masked logits
    f32 [B, 45], value f32 [B], or None when `with_value` is False, which
    skips the critic).  `weights` is a list of the 12 tensors, prepared
    again by this call on the card, or a `PreparedWeights`, prepared only
    if a weight it read was written since its last preparation."""
    if obs.device.type == "cpu":
        return fused_masked_forward_plain(weights, obs, mask, with_value)
    if obs.device.type != "cuda":
        raise ValueError(f"fused_masked_forward: unsupported device {obs.device}")
    H = _check(weights, obs, mask)
    return _launch(route(H), weights, obs, mask, with_value)


def fused_value_forward(weights, obs: torch.Tensor) -> torch.Tensor:
    """(weights, int32 obs [B, 297]) -> value f32 [B]: the critic alone,
    for callers that would drop the logits.  On the card one forward of
    the route and mode `fused_masked_forward` would take with the value,
    on the critic's head only (counted in `critic_launches`); its value is
    that call's, bit for bit.  On a CPU tensor `fused_value_forward_plain`."""
    if obs.device.type == "cpu":
        return fused_value_forward_plain(weights, obs)
    if obs.device.type != "cuda":
        raise ValueError(f"fused_value_forward: unsupported device {obs.device}")
    H = _check(weights, obs, None)
    return _launch(route(H), weights, obs, None, True)[1]


def max_clusters(H: int) -> int:
    """How many cluster-mode clusters at hidden width H the card holds at
    once."""
    n = ctypes.c_int(0)
    err = _lib().fused_actor_critic_wgmma_max_clusters(H, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"fused_actor_critic cluster occupancy query failed: CUDA error {err}")
    return n.value


def _launch(r: str, weights, obs, mask, with_value: bool, prepared=None, lib=None, mode=None):
    """One forward on route `r` of checked CUDA inputs, from `lib` (a
    library of `bind`; the library's own build unless given one); it
    prepares the weights first (a `PreparedWeights` only where it is stale)
    unless given `prepared`, and runs in the mode the shape gives
    (`wgmma_mode`, `wide_mode`) unless given `mode`.  `route(H)` and the
    modes name what the path runs; a measurement or a test may force
    another route or mode, or a probe's build.  `mask` None with
    `with_value` runs the critic alone: (None, value), in the mode of the
    call with both heads."""
    if r not in ROUTES:
        raise ValueError(f"unknown route {r!r}")
    actor = mask is not None
    if not (actor or with_value):
        raise ValueError("a forward without the mask computes the value: with_value must be True")
    B, H = obs.shape[0], weights[0].shape[1]
    if mode is None:
        mode = wgmma_mode(B, H) if r == "wgmma" else wide_mode(B, H, with_value)
    if mode not in MODES[r]:
        raise ValueError(f"unknown mode {mode!r}")
    logits = torch.empty((B, ACT_DIM), dtype=torch.float32, device=obs.device) if actor else None
    value = torch.empty((B,), dtype=torch.float32, device=obs.device) if with_value else None
    if B == 0:
        return logits, value
    logits_ptr = logits.data_ptr() if actor else None
    mask_ptr = mask.data_ptr() if actor else None
    value_ptr = value.data_ptr() if with_value else None
    lib = _lib() if lib is None else lib
    if prepared is None:
        prepared = (weights.buffer(lib) if isinstance(weights, PreparedWeights)
                    else prepare_weights(weights, with_value, lib))
    if r == "wgmma":
        groups = column_groups(H) if mode == "cluster" else 0
        err = lib.fused_actor_critic_wgmma_forward(
            obs.data_ptr(), mask_ptr, B, H, _ptrs(weights), prepared.data_ptr(),
            logits_ptr, value_ptr, groups, _stream(obs))
    else:
        scratch = torch.empty(wide_scratch_floats(min(B, WIDE_MAX_ROWS), H, with_value, actor),
                              dtype=torch.float32, device=obs.device)
        columns = PASS_COLUMNS if mode == "pass" else PASS_COLUMNS // 2
        err = 0
        for c0, n in wide_chunks(B):
            err = lib.fused_actor_critic_wide_forward(
                obs.data_ptr() + 4 * OBS_DIM * c0, mask_ptr + ACT_DIM * c0 if actor else None,
                n, H, _ptrs(weights), prepared.data_ptr(), scratch.data_ptr(), scratch.numel(),
                logits_ptr + 4 * ACT_DIM * c0 if actor else None,
                value_ptr + 4 * c0 if with_value else None, columns, _stream(obs))
            if err != 0:
                break
    if err != 0:
        raise RuntimeError(f"fused_actor_critic {r} kernel launch failed: CUDA error {err}")
    trace.count("kernel_a.launches")
    trace.count("kernel_a.route." + r)
    trace.count(("kernel_a.mode." if r == "wgmma" else "kernel_a.wide_mode.") + mode)
    if not actor:
        trace.count("kernel_a.heads.critic")
    return logits, value
