"""The fast-mode ply kernel's tables (`csrc/engine_ply.cu`), generated from
the engine's data and record layout as a C header.

`header()` generates the header's text and `write(directory)` writes it as
`engine_tables.h` (only when its text changed, so a build is not made stale
for nothing); `ops/_build` does so before it compiles the kernel.  It holds:

  * the layout: the GameState's fields in order (`LAYOUT`) as `F_<NAME>`
    indices, their words a game and their offsets in the record (`FIELD_W`,
    `FIELD_OFF`); the record, a game's fields but `deck_perm`, one int32 word
    a number (`RECORD`), as `R_<NAME>` offsets, `R_WORDS` and the padded
    stride `R_STRIDE`;
  * `CARD_PACKED[91]` (row 0 the absent card), one word a card, 4 bits a
    number: cost (5 colours, bits 0-19), colour (20-23), points (24-27),
    tier (28-31); `NOBLE_PACKED[11]` (row 0 the absent noble): requirement
    (5 colours, bits 0-19), points (20-23); `COMBO_BITS[10]`: take-3 combo
    i's colours as bits 0-4; all three in `__constant__` memory.

`unpack()` reads the packed words back into the tables of `engine/data.py`
(`CARD7_PAD`, `CARD_FEAT13`, `NOBLE_FEAT6`, `NOBLE_REQ`, `NOBLE_POINTS`,
`COMBO_MASK`), which the tests hold equal.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np

from ..engine import data as D

NAME = "engine_tables.h"

# The GameState's fields in order: (field, its C name, shape a game).
LAYOUT = (("bank", "BANK", (6,)), ("tokens", "TOKENS", (2, 6)), ("bonuses", "BONUSES", (2, 5)),
          ("prestige", "PRESTIGE", (2,)), ("reserved_ids", "RES_IDS", (2, 3)),
          ("reserved_revealed", "RES_REV", (2, 3)), ("reserved_count", "RES_CNT", (2,)),
          ("player_nobles", "PNOBLES", (2, 3)), ("noble_ids", "NOBLES", (3,)),
          ("board", "BOARD", (3, 4)), ("deck_perm", "DECK", (3, 40)),
          ("deck_count", "DECK_CNT", (3,)), ("to_play", "TO_PLAY", ()),
          ("turn_count", "TURN", ()), ("move_count", "MOVE", ()), ("game_over", "OVER", ()),
          ("winner", "WINNER", ()), ("turn_limit_reached", "LIMIT", ()))
WORDS = {field: int(np.prod(shape)) for field, _, shape in LAYOUT}
# The record: every field but deck_perm, which the ply reads one word of.
RECORD = tuple((field, name, WORDS[field]) for field, name, _ in LAYOUT if field != "deck_perm")
OFFSET = {}
_w = 0
for _field, _name, _n in RECORD:
    OFFSET[_field] = _w
    _w += _n
R_WORDS = _w
R_STRIDE = R_WORDS + 1 - R_WORDS % 2  # odd: a thread a game meets no bank conflict


def _nibbles(values) -> int:
    word = 0
    for i, v in enumerate(values):
        v = int(v)
        if not 0 <= v < 16:
            raise ValueError(f"engine tables: {v} does not fit 4 bits")
        word |= v << (4 * i)
    return word


def words() -> dict:
    """{table: [uint32 words]} of the header's packed tables."""
    card = [0]
    for i in range(D.NUM_CARDS):
        card.append(_nibbles(list(D.CARD_COST[i]) + [D.CARD_COLOR[i], D.CARD_POINTS[i],
                                                     D.CARD_TIER[i]]))
    noble = [0] + [_nibbles(list(D.NOBLE_REQ[n]) + [D.NOBLE_POINTS[n]])
                   for n in range(D.NUM_NOBLES)]
    combo = [sum(1 << c for c in range(5) if D.COMBO_MASK[i, c]) for i in range(10)]
    return {"CARD_PACKED": card, "NOBLE_PACKED": noble, "COMBO_BITS": combo}


def header() -> str:
    lines = ["// Generated from splendax_torch/engine/data.py and the record layout by",
             "// splendax_torch/ops/engine_tables.py; do not edit.", "", "#pragma once", "",
             "#include <cstdint>", ""]
    for i, (field, name, _) in enumerate(LAYOUT):
        lines.append(f"constexpr int F_{name} = {i};  // {field}")
    lines += [f"constexpr int N_FIELDS = {len(LAYOUT)};", ""]
    for field, name, _ in RECORD:
        lines.append(f"constexpr int R_{name} = {OFFSET[field]};")
    lines += [f"constexpr int R_WORDS = {R_WORDS};", f"constexpr int R_STRIDE = {R_STRIDE};", ""]
    widths = ", ".join(str(WORDS[f]) for f, _, _ in LAYOUT)
    offsets = ", ".join(str(OFFSET.get(f, -1)) for f, _, _ in LAYOUT)
    lines += [f"__constant__ int FIELD_W[N_FIELDS] = {{{widths}}};  // words a game",
              f"__constant__ int FIELD_OFF[N_FIELDS] = {{{offsets}}};  // in the record, or -1", ""]
    for name, w in words().items():
        body = ", ".join(f"0x{x:08x}u" for x in w)
        lines.append(f"__constant__ uint32_t {name}[{len(w)}] = {{{body}}};")
    return "\n".join(lines) + "\n"


def write(directory) -> Path:
    """Write the header into `directory` unless it is there already."""
    path = Path(directory) / NAME
    text = header()
    if not path.exists() or path.read_text() != text:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".h.{os.getpid()}.tmp")
        tmp.write_text(text)
        tmp.replace(path)
    return path


def _tables(text: str) -> dict:
    return {m.group(1): [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", m.group(2))]
            for m in re.finditer(r"__constant__ uint32_t (\w+)\[\d+\] = \{([^}]*)\};", text)}


def _nib(x, i):
    return (x >> (4 * i)) & 15


def unpack(text: str) -> dict:
    """The tables of `engine/data.py`, read back from a header's text."""
    w = _tables(text)
    card = np.array([[_nib(x, i) for i in range(8)] for x in w["CARD_PACKED"]], np.int32)
    noble = np.array([[_nib(x, i) for i in range(6)] for x in w["NOBLE_PACKED"]], np.int32)
    feat13 = np.zeros((len(card), 13), np.int32)
    present = np.arange(len(card)) > 0
    feat13[:, 0] = present
    feat13[:, 1] = card[:, 7]
    feat13[:, 2] = card[:, 6]
    feat13[present, 3 + card[present, 5]] = 1
    feat13[:, 8:13] = card[:, :5]
    feat6 = np.zeros((len(noble), 6), np.int32)
    feat6[1:, 0] = 1
    feat6[:, 1:] = noble[:, :5]
    return {
        "CARD7_PAD": card[:, :7],
        "CARD_FEAT13": feat13,
        "NOBLE_FEAT6": feat6,
        "NOBLE_REQ": noble[1:, :5],
        "NOBLE_POINTS": noble[1:, 5],
        "COMBO_MASK": np.array([[(x >> c) & 1 for c in range(5)] for x in w["COMBO_BITS"]],
                               np.int32),
    }
