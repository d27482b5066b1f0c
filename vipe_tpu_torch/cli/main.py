"""``python -m vipe_tpu_torch.cli.main infer VIDEO [--output DIR]
[--pipeline NAME] [--device cuda|cpu] [overrides...]`` (port of
``vipe_tpu/cli/main.py``'s ``infer``).  ``click`` is imported only here,
when the command line is parsed."""

from __future__ import annotations


def build_cli():
    import click

    from ..utils.config import compose, get_config_path

    @click.group()
    def vipe():
        """Video annotation (poses, intrinsics) in PyTorch on one GPU."""

    @vipe.command()
    @click.argument("video", type=click.Path(exists=True))
    @click.option("--output", default="vipe_results", help="artifact output root")
    @click.option("--pipeline", default="default", help="pipeline config name")
    @click.option("--device", default="cuda", help="torch device (cuda or cpu)")
    @click.argument("overrides", nargs=-1)
    def infer(video, output, pipeline, device, overrides):
        """Annotate one mp4 (poses + intrinsics + rgb + info artifacts)."""
        from ..pipeline import make_pipeline
        from ..streams.raw_mp4_stream import RawMp4Stream
        from ..utils.logging import get_logger

        logger = get_logger()
        if not (get_config_path() / "pipeline" / f"{pipeline}.yaml").exists():
            known = sorted(p.stem for p in (get_config_path() / "pipeline").glob("*.yaml"))
            raise click.BadParameter(f"unknown pipeline {pipeline!r}; available: {', '.join(known)}")
        cfg = compose(get_config_path(), "default", [f"pipeline={pipeline}"] + list(overrides))
        pcfg = cfg["pipeline"]
        pcfg.setdefault("output", {})
        pcfg["output"]["path"] = output
        stream = RawMp4Stream(video).cache()
        pipe = make_pipeline(pcfg, device=device)
        if pipe.should_filter(stream.name()):
            logger.info(f"skipping {stream.name()} (exists)")
            return
        logger.info(f"running pipeline on {video} ({device})")
        pipe.run(stream)
        logger.info(f"artifacts saved under {output}")

    return vipe


def main():
    build_cli()()


if __name__ == "__main__":
    main()
