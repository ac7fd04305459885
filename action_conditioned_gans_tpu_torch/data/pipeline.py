"""Dataset construction: config -> batch stream (port of the synthetic branch
of the JAX package's ``data/pipeline.py``).

Only the on-device synthetic source is ported. The file sources
(``tfrecord``, ``tfrecord_native``) wait on ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

from action_conditioned_gans_tpu_torch.config import Config
from action_conditioned_gans_tpu_torch.data.synthetic import SyntheticClips

FILE_SOURCES = ("tfrecord", "tfrecord_native")


def make_dataset(cfg: Config, stack: int = 1, start_call: int = 0, device=None) -> SyntheticClips:
    """The training batch stream of ``cfg``: clips of ``rollout_length + 1``
    frames, (stack, B, ...) when ``stack`` > 1, on ``device`` (cuda unless
    another device is given).

    ``start_call`` is the number of ``batch_at`` calls an interrupted run
    already consumed. The synthetic stream is addressed by the call index
    (the loop asks for ``batch_at(start // k)`` on resume), so it needs no
    fast-forward and ignores it, as the JAX package's does.
    """
    d, t, m = cfg.data, cfg.train, cfg.model
    del start_call
    if d.source in FILE_SOURCES:
        raise NotImplementedError(
            f"data.source={d.source!r} is not ported yet (ROADMAP Queue 1 item 7); "
            "the port trains on data.source='synthetic'"
        )
    if d.source != "synthetic":
        raise ValueError(f"unknown data source {d.source!r}")
    return SyntheticClips(
        batch=t.batch_size,
        seq_len=t.rollout_length + 1,
        image_size=m.image_size,
        action_dim=m.action_dim,
        with_state=True,
        seed=t.seed,
        stack=stack,
        frames_dtype=d.device_dtype,
        device=device,
    )
