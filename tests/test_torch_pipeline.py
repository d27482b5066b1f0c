"""The port's pipeline, CLI, artifacts and host layer, on the CPU.

* ``python -m vipe_tpu_torch.cli.main infer <tiny mp4> --device cpu`` with
  SLAM-size overrides (a 64×48 SLAM frame, 4 warm-up keyframes, 2 backend
  iterations) and the post-SLAM depth of ``static_vda.yaml``
  (``adaptive_constant-2.0_svda``; the process's model cache holds VDA-S
  and PriorDA at ``input_size`` 70, seeded) writes the artifact tree that
  ``vipe_tpu.utils.io`` writes for the same results, depth included, and
  ``vipe_tpu``'s readers and ``evaluate`` command read it back.
* The same subprocess then lists the modules it imported: no ``jax``,
  ``flax`` or ``vipe_tpu``.
* ``VideoFrame.resize`` (torch bilinear, half-pixel centres) against
  ``vipe_tpu``'s ``cv2.resize``: at most 1 uint8 step apart per pixel
  (the two round float32 weights differently), 0.5 steps on average.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
H, W, FRAMES = 48, 64, 24
OVERRIDES = ["pipeline.slam.resize_area=3072", "pipeline.slam.warmup=4",
             "pipeline.slam.backend_iters=2", "pipeline.slam.infill_chunk_size=8",
             "pipeline.post.depth_align_model=adaptive_constant-2.0_svda"]

# runs the CLI in-process with small depth models in the model cache, then
# reports which heavy packages got imported
_CLI_AND_MODULES = """
import json, sys
from vipe_tpu_torch.cli.main import main
from vipe_tpu_torch.models.model_cache import cached_global
from vipe_tpu_torch.priors.depth.priorda import PriorDAModel
from vipe_tpu_torch.priors.depth.videodepthanything import VideoDepthAnythingModel
cached_global(("vda", VideoDepthAnythingModel, "vits", "cpu"),
              lambda: VideoDepthAnythingModel("vits", input_size=70, device="cpu"))
cached_global(("priorda", PriorDAModel, True, "cpu"),
              lambda: PriorDAModel("vits", input_size=70, coarse_only=True, device="cpu"))
sys.argv = ["vipe"] + sys.argv[1:]
try:
    main()
except SystemExit as e:
    if e.code:
        raise
mods = sorted({m.split(".")[0] for m in sys.modules} & {"jax", "flax", "vipe_tpu"})
print("MODULES " + json.dumps(mods))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs thousands of tiny ops: intra-op threads
    only contend with the other test workers on the same cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)



@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    import cv2

    path = tmp_path_factory.mktemp("clip") / "verify_clip.mp4"
    rng = np.random.default_rng(0)
    base = (rng.random((H + 32, W + 32, 3)) * 255).astype(np.uint8)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    for k in range(FRAMES):
        w.write(base[k % 32: k % 32 + H, k % 32: k % 32 + W])
    w.release()
    return path


@pytest.fixture(scope="module")
def port_run(clip, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_out")
    proc = subprocess.run(
        [sys.executable, "-c", _CLI_AND_MODULES, "infer", str(clip), "--output", str(out),
         "--device", "cpu", *OVERRIDES],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "VIPE_WEIGHTS_DIR": str(tmp_path_factory.mktemp("no_weights"))},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("MODULES ")][-1]
    return out, json.loads(line.split(" ", 1)[1])


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


def test_artifact_tree_matches_vipe_tpu_writers(port_run, tmp_path):
    from vipe_tpu.utils import io as jio

    out, _ = port_run
    art = jio.ArtifactPath(out, "verify_clip")
    mats, inds = jio.read_pose_artifacts(art)
    intr, camera_type = jio.read_intrinsics_artifacts(art)
    info = jio.read_info(art)
    assert mats.shape == (FRAMES, 4, 4) and np.isfinite(mats).all()
    np.testing.assert_array_equal(inds, np.arange(FRAMES))
    assert intr.shape == (FRAMES, 4) and np.isfinite(intr).all()
    assert camera_type == "pinhole"
    assert np.isfinite(info["ba_residual"])

    depths = list(jio.read_depth_artifacts(art))
    assert len(depths) == FRAMES
    for d in depths:
        assert d.shape == (H, W) and np.isfinite(d).all() and (d > 0).all()

    # the JAX package's writers, given the same results, write the same tree
    ref = jio.ArtifactPath(tmp_path, "verify_clip")
    jio.save_poses(ref, mats, inds)
    jio.save_intrinsics(ref, intr[0], camera_type, n_frames=FRAMES)
    jio.save_info(ref, info)
    jio.save_rgb_video(ref, [np.zeros((H, W, 3), np.uint8)] * FRAMES)
    jio.save_depth_zip(ref, iter(depths))
    assert _tree(out) == _tree(tmp_path)
    for a, b in zip(depths, jio.read_depth_artifacts(ref)):
        np.testing.assert_array_equal(a, b)
    for rel in ("pose/verify_clip.npz", "intrinsics/verify_clip.npz",
                "intrinsics/verify_clip_camera.txt", "vipe/verify_clip_info.pkl"):
        assert (out / rel).read_bytes() == (tmp_path / rel).read_bytes(), rel


def test_rgb_artifact_has_every_frame(port_run):
    import cv2

    out, _ = port_run
    cap = cv2.VideoCapture(str(out / "rgb" / "verify_clip.mp4"))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    size = (int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)))
    cap.release()
    assert n == FRAMES and size == (H, W)


def test_vipe_tpu_evaluate_reads_port_artifacts(port_run, tmp_path):
    from click.testing import CliRunner

    from vipe_tpu.cli.main import vipe
    from vipe_tpu.utils import io as jio

    out, _ = port_run
    art = jio.ArtifactPath(out, "verify_clip")
    mats, inds = jio.read_pose_artifacts(art)
    gt = jio.ArtifactPath(tmp_path, "verify_clip")
    jio.save_poses(gt, mats, inds)
    jio.save_depth_zip(gt, jio.read_depth_artifacts(art))
    res = CliRunner().invoke(vipe, ["evaluate", str(out), str(tmp_path)])
    assert res.exit_code == 0, res.output
    metrics = json.loads(res.output[res.output.index("{"):])
    assert metrics["verify_clip"]["ate_rmse"] < 1e-5
    assert metrics["verify_clip"]["depth_abs_rel"] < 1e-3


def test_port_imports_no_jax(port_run):
    _, mods = port_run
    assert mods == []


def test_unported_pipeline_options_raise():
    """The options the port does not run are refused: a rig with
    TrackAnything instances (before a frame is read); ``slam.sparse_tracks``,
    ``slam.infill_dense_disp``, the post-SLAM depth and TrackAnything on one
    view are not."""
    from vipe_tpu_torch.pipeline.default import DefaultAnnotationPipeline
    from vipe_tpu_torch.slam.system import SLAMSystem
    from vipe_tpu_torch.streams.base import MultiviewVideoList, VideoStream

    class Unread(VideoStream):
        def __len__(self):
            return 4

        def __iter__(self):
            raise AssertionError("a frame was read")

    pipe = DefaultAnnotationPipeline(device="cpu", init={"instance": "track_anything"})
    rig = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32), (2, 1))
    with pytest.raises(NotImplementedError, match="rig"):
        pipe.run(MultiviewVideoList("rig", [Unread(), Unread()], rig))
    for key, value in (("sparse_tracks", {"name": "lk"}), ("infill_dense_disp", True)):
        pipe = DefaultAnnotationPipeline(device="cpu", slam={key: value})
        slam = SLAMSystem(config=pipe.slam_cfg, device="cpu", update_fn=lambda *a: None)
        assert slam.config[key] == value
    DefaultAnnotationPipeline(device="cpu", post={"depth_align_model": "adaptive_unidepth-l_vda",
                                                  "overlap_vda": True},
                              init={"overlap": True})


def test_default_device_needs_cuda():
    import torch

    from vipe_tpu_torch.pipeline.default import DefaultAnnotationPipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        DefaultAnnotationPipeline()


def test_port_config_matches_jax_default():
    """configs/pipeline/default.yaml, key for key and value for value (the
    SLAM section's speculative ordering included); only the pipeline class
    differs."""
    from vipe_tpu.utils.config import compose as jcompose
    from vipe_tpu_torch.utils.config import compose, get_config_path

    port = compose(get_config_path(), "default", ["pipeline=default"])["pipeline"]
    jax_cfg = jcompose(ROOT / "configs", "default", ["pipeline=default"])["pipeline"]
    assert port["instance"] == "vipe_tpu_torch.pipeline.default.DefaultAnnotationPipeline"
    assert port["slam"]["keyframe_spec_depth"] == 2 and port["slam"]["proximity_spec"] is True
    assert port["slam"] == jax_cfg["slam"]
    port.pop("instance"), jax_cfg.pop("instance")
    assert port == jax_cfg


@pytest.mark.parametrize("name", ["static_vda", "no_vda", "full"])
def test_port_config_variants_match_jax(name):
    """configs/pipeline/{static_vda,no_vda,full}.yaml key for key; only the
    pipeline class differs."""
    from vipe_tpu.utils.config import compose as jcompose
    from vipe_tpu_torch.utils.config import compose, get_config_path

    port = compose(get_config_path(), "default", [f"pipeline={name}"])["pipeline"]
    jax_cfg = jcompose(ROOT / "configs", "default", [f"pipeline={name}"])["pipeline"]
    assert port.pop("instance") == "vipe_tpu_torch.pipeline.default.DefaultAnnotationPipeline"
    assert jax_cfg.pop("instance") == "vipe_tpu.pipeline.default.DefaultAnnotationPipeline"
    assert port == jax_cfg


@pytest.mark.parametrize("size", [(36, 50), (96, 128), (29, 41)])
def test_resize_matches_cv2(size):
    from vipe_tpu.streams.base import VideoFrame as JaxFrame
    from vipe_tpu_torch.streams.base import VideoFrame

    rng = np.random.default_rng(1)
    rgb = (rng.integers(0, 256, (H, W, 3)) / 255.0).astype(np.float32)
    intr = np.array([60.0, 61.0, 32.0, 24.0], np.float32)
    got = VideoFrame(0, rgb, intrinsics=intr).resize(size)
    ref = JaxFrame(0, rgb, intrinsics=intr).resize(size)
    a = np.rint(got.rgb * 255.0)
    b = np.rint(ref.rgb * 255.0)
    assert got.rgb.shape == ref.rgb.shape == size + (3,)
    assert np.abs(a - b).max() <= 1.0 and np.abs(a - b).mean() <= 0.5
    np.testing.assert_allclose(got.intrinsics, ref.intrinsics, rtol=1e-6)


def test_port_sources_import_no_jax():
    """No module of the port and not ``chip_smoke.py`` imports ``jax``,
    ``flax`` or ``vipe_tpu``, at any depth of any function (the subprocess
    test above sees only what one CLI run imports)."""
    import ast

    banned = {"jax", "flax", "vipe_tpu"}
    files = sorted((ROOT / "vipe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: imports {name}"
