"""Batch entry of the port (counterpart of the repo's root ``run.py``)::

    python -m vipe_tpu_torch.run [overrides...]

Composes the port's ``configs/default.yaml`` with the overrides, builds the
``streams`` list (``StreamList.make``: a directory of mp4s by default, or a
rig capture with ``streams.instance=vipe_tpu_torch.streams.raw_mp4_stream.
MultiviewMp4StreamList streams.videos=[a.mp4,b.mp4] streams.rig=rig.npy``)
and runs a fresh pipeline per video on ``pipeline.device`` (``cuda`` unless
``pipeline.device=cpu``), skipping the videos whose artifacts exist when
``pipeline.output.skip_exists`` is set.  ``num_shards`` and ``interleave``
above 1 are not ported yet.
"""

from __future__ import annotations

import sys


def main(overrides):
    from .pipeline import make_pipeline
    from .streams.base import StreamList
    from .utils.config import compose, get_config_path
    from .utils.logging import get_logger

    logger = get_logger()
    cfg = compose(get_config_path(), "default", overrides)
    for key in ("num_shards", "interleave"):
        if int(cfg.get(key, 1)) > 1:
            raise NotImplementedError(f"{key} > 1 is not ported yet")
    streams = StreamList.make(cfg["streams"])
    for k, stream in enumerate(streams):
        pipeline = make_pipeline(cfg["pipeline"])
        if pipeline.should_filter(stream.name()):
            logger.info(f"skip existing: {stream.name()}")
            continue
        logger.info(f"[{k + 1}/{len(streams)}] {stream.name()} ({pipeline.device})")
        pipeline.run(stream.cache())


if __name__ == "__main__":
    main(sys.argv[1:])
