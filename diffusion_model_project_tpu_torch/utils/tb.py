"""Optional TensorBoard scalar logging for the training drivers (the port's
own copy of the JAX package's ``utils/tb.py``).

The reference's only observability is print() + the log.json / vae_log.json
histories (SURVEY.md §5; reference train.py:56-83, train_3d_vae_only.py:329).
Those JSON contracts stay the source of truth here — the offline plot scripts
and ``from_directory`` loaders parse them — and TensorBoard is a strictly
additive mirror: when a trainer is run with ``--tensorboard true``, every
scalar appended to the JSON history is also written as a TB scalar under
``<run_dir>/tb/``, so live curves are one ``tensorboard --logdir`` away.

Design constraints:
  - zero new hard dependencies: uses tensorboardX when importable, otherwise
    degrades to a no-op with a single warning (the JSON log is never at risk);
  - resume-safe: scalars are keyed by epoch, and a resumed run re-opens the
    same event directory with ``purge_step`` so abandoned-epoch events from a
    crashed run are dropped exactly like the JSON history is truncated.
"""
from __future__ import annotations

import math
import warnings


class TensorBoardLogger:
    """add_scalars(epoch, {...}) -> TB events; no-op when TB is unavailable.

    A None/falsy ``logdir`` also yields a no-op instance, so call sites can
    unconditionally create one and log through it.
    """

    def __init__(self, logdir, *, purge_step=None):
        self._writer = None
        if not logdir:
            return
        try:
            from tensorboardX import SummaryWriter
        except Exception as e:  # pragma: no cover - env without tensorboardX
            warnings.warn(f"tensorboardX unavailable ({e}); TensorBoard "
                          "logging disabled, JSON logs unaffected")
            return
        # resumes tag their event file so readers order it after the original
        # run's file even when both were created within the same second
        # (event files are sorted by path; same-second names otherwise tie)
        self._writer = SummaryWriter(
            logdir=str(logdir), purge_step=purge_step,
            filename_suffix=".resume" if purge_step is not None else "")

    @property
    def enabled(self) -> bool:
        return self._writer is not None

    def add_scalars(self, step: int, scalars: dict, prefix: str = "") -> None:
        """Write every finite numeric value in ``scalars`` at ``step``."""
        if self._writer is None:
            return
        for key, value in scalars.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(value):  # NaN/inf would wreck the chart axis
                continue
            self._writer.add_scalar(f"{prefix}{key}", value, global_step=step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
