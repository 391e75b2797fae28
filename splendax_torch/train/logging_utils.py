"""Training observability: TensorBoard scalars, in-memory history, summary
plots.

The port's own copy of `splendax/train/logging_utils.py` (the port imports
nothing of the JAX package).  Capability parity with the reference
`training_utils.py`:
`TrainingHistory` (:31-46), `TrainingLogger` TB scalars for losses/LR/
win-rates ± CI (:58-90), history accumulation (:92-107), and the 2x2
matplotlib summary figure saved timestamped + as `summary.png` (:109-176).
TensorBoard and matplotlib are optional (gated imports); a JSONL metrics
stream is always written so headless runs stay observable.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class TrainingHistory:
    """Reference TrainingHistory (training_utils.py:31-46)."""

    steps: List[int] = field(default_factory=list)
    win_rates: Dict[str, List[float]] = field(default_factory=dict)
    win_rate_cis: Dict[str, List[float]] = field(default_factory=dict)
    avg_turns: Dict[str, List[float]] = field(default_factory=dict)
    policy_losses: List[float] = field(default_factory=list)
    value_losses: List[float] = field(default_factory=list)
    entropies: List[float] = field(default_factory=list)
    learning_rates: List[float] = field(default_factory=list)


class TrainingLogger:
    def __init__(self, log_dir: str, track: bool = False, write: bool = True,
                 wandb_project: Optional[str] = None,
                 wandb_entity: Optional[str] = None,
                 config: Optional[Dict] = None):
        """`write=False` makes every output a no-op (no files, no TB) while
        keeping the API, so that in a multi-process run only one process
        touches the disk.

        `wandb_project` enables the reference's third tracking channel
        (ppo_cleanRL.py:135-151: wandb.init + per-step wandb.log of the
        same scalars TensorBoard gets).  Optional-gated like TB: if wandb
        is not importable the run degrades to TB + JSONL with a one-line
        notice."""
        self.log_dir = log_dir
        self.track = track and write
        self.write = write
        self.run_start_ts = time.strftime("%Y%m%d_%H%M%S")
        self.history = TrainingHistory()
        self._jsonl = None
        if write:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self.writer = None
        if self.track:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir)
            except Exception as e:  # pragma: no cover
                print(f"[logger] tensorboard unavailable ({e}); JSONL only")
        self._wandb = None
        if wandb_project and write:
            try:
                import wandb

                wandb.init(
                    project=wandb_project, entity=wandb_entity,
                    name=f"{os.path.basename(log_dir)}_{self.run_start_ts}",
                    dir=log_dir, config=config,
                )
                self._wandb = wandb
            except Exception as e:
                print(f"[logger] wandb unavailable ({e}); TB/JSONL only")

    def _scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        if self._wandb is not None:
            self._wandb.log({tag: value}, step=step)

    def log_training_metrics(self, global_step: int, lr: float, policy_loss: float,
                             value_loss: float, entropy: float, approx_kl: float,
                             extra: Optional[Dict] = None) -> None:
        if not self.write:
            return
        rec = {
            "type": "train", "step": int(global_step), "lr": float(lr),
            "policy_loss": float(policy_loss), "value_loss": float(value_loss),
            "entropy": float(entropy), "approx_kl": float(approx_kl),
        }
        if extra:
            rec.update({k: float(v) for k, v in extra.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        for tag, v in (("charts/learning_rate", lr), ("losses/policy_loss", policy_loss),
                       ("losses/value_loss", value_loss), ("losses/entropy", entropy),
                       ("losses/approx_kl", approx_kl)):
            self._scalar(tag, float(v), global_step)

    def log_evaluation_results(self, results: Dict[str, Dict], global_step: int) -> None:
        if not self.write:
            return
        rec = {"type": "eval", "step": int(global_step)}
        for name, res in results.items():
            # scalars only in the JSONL record (eval dicts also carry a
            # nested `privileged` flag dict, eval/suite.py:is_privileged)
            rec[name] = {
                k: float(v) for k, v in res.items()
                if isinstance(v, (int, float, bool))
            }
            self._scalar(f"eval/{name}/win_rate", res["win_rate"], global_step)
            self._scalar(f"eval/{name}/win_rate_ci95", res["win_rate_ci95"], global_step)
            self._scalar(f"eval/{name}/avg_turns", res["avg_turns"], global_step)
            self._scalar(f"eval/{name}/draw_rate", res["draws"] / max(1, res["n"]),
                         global_step)
            self._scalar(f"eval/{name}/avg_prestige", res["avg_prestige"], global_step)
            self._scalar(f"eval/{name}/illegal_action_rate",
                         res["illegal_action_rate"], global_step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def update_history(self, global_step: int, results: Dict[str, Dict], lr: float,
                       policy_loss: float, value_loss: float, entropy: float) -> None:
        h = self.history
        h.steps.append(int(global_step))
        for name, res in results.items():
            h.win_rates.setdefault(name, []).append(res["win_rate"])
            h.win_rate_cis.setdefault(name, []).append(res["win_rate_ci95"])
            h.avg_turns.setdefault(name, []).append(res["avg_turns"])
        h.policy_losses.append(float(policy_loss))
        h.value_losses.append(float(value_loss))
        h.entropies.append(float(entropy))
        h.learning_rates.append(float(lr))

    def create_summary_plot(self, global_step: int) -> Optional[str]:
        """2x2 summary figure: win rates ± CI / avg turns / losses / LR
        (training_utils.py:109-176).  Saved timestamped + as summary.png."""
        if not self.write:
            return None
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception as e:  # pragma: no cover
            print(f"[logger] matplotlib unavailable ({e}); skipping plot")
            return None
        h = self.history
        if not h.steps:
            return None
        fig, axes = plt.subplots(2, 2, figsize=(12, 8))
        ax = axes[0, 0]
        for name, wr in h.win_rates.items():
            ci = h.win_rate_cis.get(name, [0] * len(wr))
            ax.errorbar(h.steps, wr, yerr=ci, label=name, capsize=2)
        ax.set_title("Win rates vs opponents")
        ax.set_xlabel("env steps")
        ax.set_ylim(0, 1)
        ax.legend(fontsize=8)
        ax = axes[0, 1]
        for name, turns in h.avg_turns.items():
            ax.plot(h.steps, turns, label=name)
        ax.set_title("Average game length (turns)")
        ax.legend(fontsize=8)
        ax = axes[1, 0]
        ax.plot(h.steps, h.policy_losses, label="policy")
        ax.plot(h.steps, h.value_losses, label="value")
        ax.plot(h.steps, h.entropies, label="entropy")
        ax.set_title("Losses")
        ax.legend(fontsize=8)
        ax = axes[1, 1]
        ax.plot(h.steps, h.learning_rates)
        ax.set_title("Learning rate")
        fig.tight_layout()
        ts_path = os.path.join(
            self.log_dir, f"summary_{self.run_start_ts}_{global_step}.png"
        )
        latest = os.path.join(self.log_dir, "summary.png")
        fig.savefig(ts_path, dpi=100)
        fig.savefig(latest, dpi=100)
        if self.writer is not None:
            self.writer.add_figure("charts/summary", fig, global_step)
        plt.close(fig)
        return latest

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self.writer is not None:
            self.writer.close()
        if self._wandb is not None:
            self._wandb.finish()


def linear_lr_schedule(base_lr: float, progress: float) -> float:
    """Reference linear_lr_schedule (training_utils.py:279-281)."""
    return base_lr * progress
