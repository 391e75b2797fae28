"""Reduced-colour Take-3 demo.

Counterpart of `splendax/tools/take3_demo.py`: the variant's semantics on
live engine states:
  * >= 3 bank colours: a combo is legal iff ALL its colours are available;
  * 1-2 colours left: a combo is legal iff available ⊆ combo (3 legal combos
    at 2 colours, 6 at 1), and it takes only the available subset.

Run: python -m splendax_torch.tools.take3_demo   (on the card; or
`main(device="cpu")`)
"""

from __future__ import annotations


def main(device="cuda") -> None:
    import torch

    from ..engine import data as D
    from ..engine import rules as R
    from ..engine.state import initial_state_parity

    names = ["W", "B", "G", "R", "K"]

    def combo_str(i):
        return "+".join(names[c] for c in D.TAKE3_COMBOS[i])

    def show(bank5):
        state = initial_state_parity(0, device)
        state = state.replace(bank=torch.tensor([list(bank5) + [5]], dtype=torch.int32,
                                                device=state.bank.device))
        mask = R.legal_mask(state)[0, :10].cpu().numpy()
        legal = [combo_str(i) for i in mask.nonzero()[0]]
        print(f"bank {dict(zip(names, bank5))}: {int(mask.sum())} legal combos"
              f" -> {legal}")
        if mask.any():
            a = int(mask.nonzero()[0][0])
            nxt = R.apply_action(state, torch.tensor([a], device=state.bank.device))
            taken = (state.bank - nxt.bank)[0, :5].tolist()
            print(f"  executing {combo_str(a)} takes "
                  f"{ {names[i]: int(t) for i, t in enumerate(taken) if t} }")

    print("Full bank (>=3 colors): standard rule, combo needs all 3 colors")
    show([4, 4, 4, 4, 4])
    print("\nOne color exhausted: combos containing it become illegal")
    show([0, 4, 4, 4, 4])
    print("\nTwo colors left: available ⊆ combo — exactly 3 legal combos")
    show([0, 0, 0, 2, 1])
    print("\nOne color left: 6 legal combos, each takes just that one token")
    show([0, 0, 0, 3, 0])
    print("\nEmpty bank: no take-3 at all")
    show([0, 0, 0, 0, 0])


if __name__ == "__main__":
    main()
