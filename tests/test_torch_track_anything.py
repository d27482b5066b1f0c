"""The port's TrackAnything (``init.instance: track_anything``) against
``vipe_tpu``'s: the morphology, SAM, GroundingDINO (BERT, Swin, the
deformable sampling, the model and the detector), DeAOT (the net and the
tracker), the weight converters, ``TrackAnythingPipeline`` and
``TrackAnythingProcessor`` inside ``DefaultAnnotationPipeline``.

Both sides run the same weights: the port's seeded initialisation
(``models.vit.init_seeded_``: variance 1/fan_in, biases 0, norms at
identity) with every 1-D weight, bias and norm moved by 0.1·N(0, 1), at
small widths (``GDINOConfig.tiny()``, ``DeAOTConfig.tiny()``, SAM's encoder
64 wide, 3 blocks with global attention at block 1 and 4×4 windows, on a
96² canvas), handed to the JAX package through its own converters
(``convert_sam``, ``convert_gdino``, ``convert_deaot``).  Frames are 64×96
(GroundingDINO's short side 64 and long side 96, DeAOT's long edge 96), so
every preprocessing resize is the identity on both sides and the nets see
equal inputs; the resizes are held to OpenCV on their own.  The JAX
references run in two spawned processes (``BackgroundJax``) that the
module's first test starts; the port's own work runs before the first wait
on them.

Tolerances:
* ``erode``, ``dilate``, the tokenizer, the phrase masks, the converters'
  round trips and the uint8 and nearest-neighbour resizes (against
  OpenCV): exactly equal;
* each net's continuous outputs (SAM's embedding, mask logits and IoU,
  BERT, Swin, GroundingDINO's logits and boxes, DeAOT's memories and
  logits) within ``NET_RTOL`` (1e-4) of the largest value, f32 on both
  sides; ``ms_deform_attn`` within 1e-5, with points outside the maps;
* decisions (the box threshold and score-ordered cap, SAM's mask
  threshold, DeAOT's slot arg-max) equal wherever the port's margin to the
  decision passes ``NET_RTOL`` of the largest value; the test prints how
  many flip below it;
* ``TrackAnythingPipeline.track`` over 5 frames (``sam_gap`` 2) and the
  processor inside the pipeline: instance maps, id → phrase maps, frame
  masks and mask artifacts equal frame by frame;
* GroundingDINO's float bilinear resize against OpenCV's: within 1e-4 of
  the pixel range.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slam import BackgroundJax, _rel
from vipe_tpu_torch.models import convert as tconvert

H, W = 64, 96
SAM_IMG = 96
SAM_SMALL = dict(embed_dim=64, depth=3, num_heads=2, global_attn=(1,), window_size=4)
PHRASES = ["person", "car", "sky"]
BOXES = np.asarray([[4, 6, 60, 50], [30, 10, 95, 63], [0, 0, 40, 30], [50, 40, 52, 43]],
                   np.float32)
NET_RTOL = 1e-4
MSDA_TOL = 1e-5
SAM_MIN_AREA = 3000  # between the masks' areas: the composite drops some
N_TRACK = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _no_hf_tokenizer():
    """Both packages' ``make_tokenizer`` fall back to ``HashTokenizer``
    without a cached HuggingFace vocabulary; make that fallback immediate
    (no ``transformers`` import) in this process."""
    import sys

    prev = sys.modules.get("transformers", False)
    sys.modules["transformers"] = None
    return prev


@pytest.fixture(autouse=True, scope="module")
def _hash_tokenizer():
    import sys

    prev = _no_hf_tokenizer()
    yield
    if prev is False:
        del sys.modules["transformers"]
    else:
        sys.modules["transformers"] = prev


# ------------------------------------------------------------------ inputs


def _frames(n=N_TRACK, seed=0):
    """(H, W, 3) frames in [0, 1] with 1/255 steps: two blocks of colour on
    a noisy canvas, moving 2 px a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W + 2 * n, 3))
    base[10:40, 20:50] = (200, 40, 40)
    base[30:60, 60:80] = (30, 60, 220)
    return [(base[:, 2 * k: 2 * k + W] / 255.0).astype(np.float32) for k in range(n)]


def _instance():
    inst = np.zeros((H, W), np.int32)
    inst[8:40, 10:50] = 3
    inst[30:62, 55:90] = 7
    return inst


def _perturbed(net, seed):
    """The net's state dict as numpy, every 1-D tensor moved by 0.1·N(0, 1)
    (frozen batch-norm variances kept)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in net.state_dict().items():
        a = v.numpy().copy()
        if a.ndim == 1 and not k.endswith("running_var"):
            a += 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        sd[k] = a
    return sd


@functools.lru_cache(maxsize=None)
def _weights():
    """name → the port's seeded, perturbed state dict (numpy), alike in
    every process."""
    from vipe_tpu_torch.priors.track_anything.deaot import DeAOTConfig, build_deaot
    from vipe_tpu_torch.priors.track_anything.gdino import GDINOConfig, build_gdino
    from vipe_tpu_torch.priors.track_anything.sam import build_sam

    torch.set_num_threads(1)
    return {"sam": _perturbed(build_sam("vit_b", None, 0, "cpu", SAM_IMG, SAM_SMALL), 1),
            "gdino": _perturbed(build_gdino(GDINOConfig.tiny(), None, 1), 2),
            "deaot": _perturbed(build_deaot(DeAOTConfig.tiny(), None, 2), 3)}


def _torch_sd(sd):
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _port_sam():
    from vipe_tpu_torch.priors.track_anything.sam import SamPredictor

    return SamPredictor("vit_b", _torch_sd(_weights()["sam"]), img_size=SAM_IMG, device="cpu",
                        cfg=SAM_SMALL)


def _port_gdino(**kw):
    from vipe_tpu_torch.priors.track_anything.gdino import GDINOConfig, GroundingDINODetector

    return GroundingDINODetector(GDINOConfig.tiny(), _torch_sd(_weights()["gdino"]),
                                 short_side=64, max_side=96, device="cpu", **kw)


def _port_deaot():
    from vipe_tpu_torch.priors.track_anything.deaot import DeAOTConfig, DeAOTTracker

    return DeAOTTracker(DeAOTConfig.tiny(), _torch_sd(_weights()["deaot"]), max_long_edge=96,
                        device="cpu")


def _port_track_anything():
    from vipe_tpu_torch.priors.track_anything import TrackAnythingPipeline

    return TrackAnythingPipeline(PHRASES, sam_gap=2, detector=_port_gdino(),
                                 tracker=_port_deaot(), segmentor=_port_sam(), device="cpu")


def _canvas():
    return np.random.default_rng(9).standard_normal((1, SAM_IMG, SAM_IMG, 3)).astype(np.float32)


def _msda_case():
    """Values over two levels and sampling points in [−0.2, 1.2]² (some
    outside the maps)."""
    rng = np.random.default_rng(11)
    shapes = [(6, 8), (3, 4)]
    value = rng.standard_normal((1, 60, 2, 4)).astype(np.float32)
    loc = (rng.random((1, 5, 2, 2, 3, 2)) * 1.4 - 0.2).astype(np.float32)
    w = rng.random((1, 5, 2, 2, 3)).astype(np.float32)
    return value, shapes, loc, w / w.sum((-1, -2), keepdims=True)


# ------------------------------------------------------ the JAX references


def _jax_sam():
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.priors.track_anything.sam import ImageEncoderViT, SamPredictor

    pred = SamPredictor("vit_b", params=jconvert.convert_sam(_weights()["sam"]), img_size=SAM_IMG)
    pred.encoder = ImageEncoderViT(img_size=SAM_IMG, **SAM_SMALL)
    return pred


def _jax_gdino(**kw):
    from vipe_tpu.priors.track_anything.gdino import GDINOConfig, GroundingDINODetector
    from vipe_tpu.priors.track_anything.gdino.convert import convert_gdino

    params = jax.tree_util.tree_map(jnp.asarray,
                                    convert_gdino(_weights()["gdino"], GDINOConfig.tiny()))
    return GroundingDINODetector(GDINOConfig.tiny(), params=params, short_side=64, max_side=96,
                                 **kw)


def _jax_deaot():
    from vipe_tpu.priors.track_anything.deaot import DeAOTConfig, DeAOTTracker
    from vipe_tpu.priors.track_anything.deaot.convert import convert_deaot

    params = jax.tree_util.tree_map(jnp.asarray,
                                    convert_deaot(_weights()["deaot"], DeAOTConfig.tiny()))
    return DeAOTTracker(DeAOTConfig.tiny(), params=params, max_long_edge=96)


def _jax_track_anything():
    from vipe_tpu.priors.track_anything import TrackAnythingPipeline

    pipe = TrackAnythingPipeline(PHRASES, sam_gap=2, detector=_jax_gdino(), tracker=_jax_deaot(),
                                 sam_params={})
    pipe.seg_tracker.segmentor = _jax_sam()
    return pipe


def _jax_nets_job():
    """SAM and GroundingDINO: the nets on fixed inputs, the predictor and
    the detector."""
    from vipe_tpu.priors.track_anything.gdino.bert import BertEncoder
    from vipe_tpu.priors.track_anything.gdino.msda import ms_deform_attn
    from vipe_tpu.priors.track_anything.gdino.swin import SwinTransformer

    _no_hf_tokenizer()
    out = {}
    sam = _jax_sam()
    emb = sam._embed(sam.params, jnp.asarray(_canvas()))
    out["sam_embed"] = np.asarray(emb)
    boxes = jnp.asarray(BOXES.reshape(-1, 2, 2))
    emb4 = jnp.broadcast_to(emb, (len(BOXES),) + emb.shape[1:])
    masks, iou = sam._decode(sam.params, emb4, boxes)
    masks2, iou2 = sam._decode_with_mask(sam.params, emb4, boxes, masks[:, 1])
    out["sam_decode"] = tuple(map(np.asarray, (masks, iou, masks2, iou2)))
    sam.set_image(_frames()[0])
    out["sam_masks"] = sam.segment_with_boxes(BOXES)
    out["sam_composite"] = sam.segment_composite(BOXES, SAM_MIN_AREA, 5)

    det = _jax_gdino(box_threshold=0.35)
    p = det._params["params"]
    ids, ids_pad, m3, pid, tmask = _text_inputs()
    out["bert"] = np.asarray(jax.jit(BertEncoder(det.cfg.bert).apply)(
        {"params": p["bert"]}, jnp.asarray(ids_pad), jnp.asarray(m3), jnp.asarray(pid)))
    c = det.cfg
    img = det._preprocess(_frames()[0])[None]
    out["swin"] = [np.asarray(f) for f in jax.jit(SwinTransformer(
        c.swin_embed_dim, c.swin_depths, c.swin_heads, c.swin_window).apply)(
        {"params": p["backbone"]}, jnp.asarray(img))]
    logits, boxes = det._apply(det._params, jnp.asarray(img), jnp.asarray(ids_pad),
                               jnp.asarray(m3), jnp.asarray(pid), jnp.asarray(tmask))
    out["gdino"] = np.asarray(logits), np.asarray(boxes)
    for cap in (100, 5):
        det.max_detections = cap
        out["grounding", cap] = det.run_grounding(_frames()[0], PHRASES, return_phrases=True)
    value, shapes, loc, w = _msda_case()
    msda = jax.jit(functools.partial(ms_deform_attn, spatial_shapes=shapes))
    out["msda"] = np.asarray(msda(jnp.asarray(value), sampling_locations=jnp.asarray(loc),
                                  attention_weights=jnp.asarray(w)))

    return out


def _jax_pipeline_job():
    """``TrackAnythingPipeline.track`` over the frames, DeAOT's net and
    tracker, and the processor inside ``DefaultAnnotationPipeline`` (the
    same engine, reset by the processor, so that its programs are compiled
    once)."""
    from vipe_tpu.priors.track_anything.deaot import _prop_step

    _no_hf_tokenizer()
    pipe = _jax_track_anything()
    out = {"track": [pipe.track(k, f) for k, f in enumerate(_frames())]}
    tr = pipe.tracker
    tr.restart()
    frames = _frames()
    img = tr._preprocess(frames[0])
    out["deaot_ref"] = [tuple(map(np.asarray, m["global"]))
                        for m in tr._jit_ref(tr._ensure_params(img, tr._slots_host(
                            _instance(), (H, W))), img, tr._slots_host(_instance(), (H, W)))]
    tr.restart()
    tr.add_reference(frames[0], _instance())
    gK, gV, gI, kmask = tr._padded_long()
    lK, lV, lI = zip(*tr.short_memory)
    norm = (tr._preprocess(frames[1]).astype(jnp.float32) / 255.0
            - jnp.asarray([0.485, 0.456, 0.406])) / jnp.asarray([0.229, 0.224, 0.225])
    prop = jax.jit(functools.partial(tr.net.apply, method=_prop_step))
    out["deaot_logits"] = np.asarray(prop(tr._params, norm, gK, gV, gI, kmask, list(lK), list(lV),
                                          list(lI))[0])
    out["deaot_track"] = _deaot_sequence(tr)
    tr.restart()
    tr.add_reference(frames[0], _overflow_instance())
    out["deaot_overflow"] = dict(tr.slot_to_id), tr.propagate(frames[1])
    out["pipeline"] = _run_pipeline("jax", pipe)
    return out


def _deaot_sequence(tr):
    """Two references and three propagations (one without a memory update,
    as on a detection frame): the instance maps."""
    frames = _frames()
    tr.restart()
    tr.add_reference(frames[0], _instance())
    seq = [tr.propagate(frames[1]), tr.propagate(frames[2])]
    seq.append(tr.propagate(frames[3], update_memory=False))
    tr.add_reference(frames[3], seq[-1])
    seq.append(tr.propagate(frames[4]))
    return seq, dict(tr.slot_to_id)


def _overflow_instance():
    """12 objects, 2 more than DeAOT's slots."""
    inst = np.zeros((H, W), np.int32)
    for k in range(12):
        inst[k * 5: k * 5 + 4, k * 7: k * 7 + 6] = 100 + k
    return inst


def _text_inputs():
    from vipe_tpu_torch.priors.track_anything.gdino import GDINOConfig
    from vipe_tpu_torch.priors.track_anything.gdino.bert import (HashTokenizer,
                                                                 generate_special_token_masks)
    from vipe_tpu_torch.priors.track_anything.gdino import text_bucket

    ids = HashTokenizer()(" . ".join(PHRASES) + " .")
    Lb = text_bucket(len(ids), GDINOConfig.tiny().max_text_len)
    ids_pad = np.zeros((1, Lb), np.int64)
    ids_pad[0, : len(ids)] = ids
    m3, pid = generate_special_token_masks(ids_pad)
    tmask = np.zeros((1, Lb), bool)
    tmask[0, : len(ids)] = True
    return ids, ids_pad, m3, pid, tmask


def _run_pipeline(pkg, engine=None):
    """``DefaultAnnotationPipeline`` of ``pkg`` ("jax" or "port") with
    ``init.instance: track_anything`` (the small engine in the package's
    model cache), its SLAM stubbed to read every frame's mask and return
    identity poses, artifacts and the visualization (rgb and instance
    panes) written; returns (the artifact tree, the frames' masks, the
    mask entries read back, the phrase file).  ``engine``: the
    TrackAnything engine to cache, else a new one."""
    import pathlib
    import tempfile
    import zipfile

    import cv2

    if pkg == "jax":
        import vipe_tpu.pipeline.default as default
        from vipe_tpu.models import model_cache as cache
        from vipe_tpu.ops.cameras import CameraType
        from vipe_tpu.priors.track_anything import TrackAnythingPipeline
        from vipe_tpu.slam.interface import SLAMOutput
        from vipe_tpu.streams.base import FrameAttribute, VideoFrame, VideoStream
        key, kw = ("track_anything", TrackAnythingPipeline, tuple(PHRASES), ()), {}
        build = _jax_track_anything
    else:
        import vipe_tpu_torch.pipeline.default as default
        from vipe_tpu_torch.models import model_cache as cache
        from vipe_tpu_torch.ops.cameras import CameraType
        from vipe_tpu_torch.priors.track_anything import TrackAnythingPipeline
        from vipe_tpu_torch.slam.interface import SLAMOutput
        from vipe_tpu_torch.streams.base import FrameAttribute, VideoFrame, VideoStream
        key, kw = ("track_anything", TrackAnythingPipeline, tuple(PHRASES), (), "cpu"), \
            {"device": "cpu"}
        build = _port_track_anything
    cache.cached_thread(key, build if engine is None else lambda: engine)
    masks = []

    class Frames(VideoStream):
        def __len__(self):
            return N_TRACK

        def name(self):
            return "clip"

        def frame_size(self):
            return (H, W)

        def fps(self):
            return 10.0

        def attributes(self):
            return {FrameAttribute.RGB}

        def __iter__(self):
            for k, rgb in enumerate(_frames()):
                yield VideoFrame(raw_frame_idx=k, rgb=rgb)

    class StubSLAM:
        def __init__(self, *a, **k):
            pass

        def run(self, stream, camera_type=None):
            masks.extend(np.asarray(f.mask) for f in stream)
            return SLAMOutput(trajectory=np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32),
                                                 (N_TRACK, 1)),
                              intrinsics=np.asarray([80.0, 80.0, W / 2, H / 2], np.float32),
                              camera_type=CameraType.PINHOLE)

    orig, default.SLAMSystem = default.SLAMSystem, StubSLAM
    root = pathlib.Path(tempfile.mkdtemp())
    try:
        default.DefaultAnnotationPipeline(
            init={"intrinsics": "fov", "instance": "track_anything", "phrases": PHRASES},
            output={"path": str(root), "save_viz": True, "viz_attributes": ["rgb", "instance"]},
            **kw).run(Frames())
    finally:
        default.SLAMSystem = orig
        cache.clear()
    tree = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    with zipfile.ZipFile(root / "mask" / "clip.zip") as z:
        entries = [cv2.imdecode(np.frombuffer(z.read(n), np.uint8), cv2.IMREAD_UNCHANGED)
                   for n in sorted(z.namelist())]
    return tree, masks, entries, (root / "mask" / "clip.txt").read_text()


# two processes, each running its jobs in order
_JAX_NETS = BackgroundJax({"nets": (_jax_nets_job, ())})
_JAX_PIPE = BackgroundJax({"pipeline": (_jax_pipeline_job, ())})


@pytest.fixture(autouse=True, scope="module")
def _jax_references():
    _JAX_NETS.start()
    _JAX_PIPE.start()
    yield
    _JAX_NETS.stop()
    _JAX_PIPE.stop()


def _held_where_decided(ref, got, margin, what):
    """``got`` equals ``ref`` wherever the port's margin to the decision
    passes ``NET_RTOL`` of the largest margin; prints the flips below it."""
    ref, got, margin = np.asarray(ref), np.asarray(got), np.asarray(margin)
    clear = margin > NET_RTOL * np.abs(margin).max()
    assert (ref == got)[clear].all(), (what, int((ref != got)[clear].sum()))
    print(f"{what}: {int((ref != got).sum())} of {ref.size} differ, "
          f"{int((~clear).sum())} within {NET_RTOL:g} of the decision")


# ------------------------------------------- host code (JAX in this process)


@pytest.mark.parametrize("op", ["erode", "dilate"])
@pytest.mark.parametrize("radius", [0, 1, 5])
def test_morphology_matches_jax(op, radius):
    from vipe_tpu.ops import morph as jmorph
    from vipe_tpu_torch.ops import morph

    rng = np.random.default_rng(radius)
    mask = rng.random((H, W)) < 0.7
    mask[20:40, 30:70] = True
    got = getattr(morph, op)(mask, radius)
    ref = getattr(jmorph, op)(mask, radius)
    assert got.dtype == ref.dtype == bool and np.array_equal(got, ref)


def test_tokenizer_and_phrase_masks_match_jax():
    from vipe_tpu.priors.track_anything.gdino import bert as jbert

    caption = "person . red car . sky ."
    ids, ids_pad, m3, pid, _ = _text_inputs()
    assert ids == jbert.HashTokenizer()(" . ".join(PHRASES) + " .")
    from vipe_tpu_torch.priors.track_anything.gdino.bert import HashTokenizer

    assert HashTokenizer()(caption) == jbert.HashTokenizer()(caption)
    ref_m3, ref_pid = jbert.generate_special_token_masks(ids_pad)
    assert np.array_equal(m3, ref_m3) and np.array_equal(pid, ref_pid)


def test_converters_round_trip():
    """``*_state_dict_from_flax(convert_*(sd))`` equals ``sd`` key for key and
    bit for bit on the JAX package's synthetic state dicts (GroundingDINO,
    DeAOT) and on a 0.02-scale one of SAM's shapes; each loads into the
    port's net with ``strict=True``."""
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.priors.track_anything.deaot import DeAOTConfig as JDeAOTConfig
    from vipe_tpu.priors.track_anything.deaot.convert import convert_deaot
    from vipe_tpu.priors.track_anything.deaot.convert import synthetic_state_dict as deaot_sd
    from vipe_tpu.priors.track_anything.gdino import GDINOConfig as JGDINOConfig
    from vipe_tpu.priors.track_anything.gdino.convert import convert_gdino
    from vipe_tpu.priors.track_anything.gdino.convert import synthetic_state_dict as gdino_sd
    from vipe_tpu_torch.priors.track_anything.deaot import DeAOTConfig, build_deaot
    from vipe_tpu_torch.priors.track_anything.gdino import GDINOConfig, build_gdino
    from vipe_tpu_torch.priors.track_anything.sam import build_sam

    rng = np.random.default_rng(0)
    sam_sd = {k: (0.02 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in _weights()["sam"].items()}
    cases = [
        ("sam", sam_sd, tconvert.sam_state_dict_from_flax(jconvert.convert_sam(sam_sd)),
         lambda sd: build_sam("vit_b", sd, img_size=SAM_IMG, cfg=SAM_SMALL)),
        ("gdino", gdino_sd(JGDINOConfig.tiny()),
         None, lambda sd: build_gdino(GDINOConfig.tiny(), sd)),
        ("deaot", deaot_sd(JDeAOTConfig.tiny()), None,
         lambda sd: build_deaot(DeAOTConfig.tiny(), sd)),
    ]
    for name, sd, back, build in cases:
        if name == "gdino":
            back = tconvert.gdino_state_dict_from_flax(convert_gdino(sd, JGDINOConfig.tiny()))
        elif name == "deaot":
            back = tconvert.deaot_state_dict_from_flax(convert_deaot(sd, JDeAOTConfig.tiny()))
        assert set(back) == set(sd), (name, sorted(set(back) ^ set(sd))[:5])
        for k, v in sd.items():
            assert back[k].dtype == torch.float32 and np.array_equal(back[k].numpy(), v), (name, k)
        net = build(back)
        assert all(np.array_equal(v.numpy(), sd[k]) for k, v in net.state_dict().items()), name


def test_zoo_reads_track_anything_families(tmp_path, monkeypatch):
    """``sam_vit_b``, ``gdino`` and ``deaot`` from the JAX package's flax
    ``.npz`` and from a ViPE ``.pth``, equal to the state dict they hold."""
    from vipe_tpu.models import convert as jconvert
    from vipe_tpu.models.zoo import flatten_tree
    from vipe_tpu.priors.track_anything.deaot import DeAOTConfig as JDeAOTConfig
    from vipe_tpu.priors.track_anything.deaot.convert import convert_deaot
    from vipe_tpu.priors.track_anything.gdino import GDINOConfig as JGDINOConfig
    from vipe_tpu.priors.track_anything.gdino.convert import convert_gdino
    from vipe_tpu_torch.models import zoo

    monkeypatch.setenv("VIPE_WEIGHTS_DIR", str(tmp_path))
    w = _weights()
    flax = {"sam_vit_b": jconvert.convert_sam(w["sam"]),
            "gdino": convert_gdino(w["gdino"], JGDINOConfig.tiny()),
            "deaot": convert_deaot(w["deaot"], JDeAOTConfig.tiny())}
    for family, tree in flax.items():
        sd = w[family.split("_")[0]]
        assert zoo.load_state_dict(family) is None
        np.savez(tmp_path / f"{family}.npz", **flatten_tree(tree))
        got = zoo.load_state_dict(family)
        assert set(got) == set(sd) and all(np.array_equal(got[k].numpy(), sd[k]) for k in sd)
        (tmp_path / f"{family}.npz").unlink()
        torch.save({"model": _torch_sd(sd)}, tmp_path / f"{family}.pth")
        got = zoo.load_state_dict(family)
        assert all(np.array_equal(got[k].numpy(), sd[k]) for k in sd)


@pytest.mark.parametrize("hw", [(50, 120), (720 // 8, 1280 // 8)])
def test_uint8_resizes_match_cv2(hw):
    """SAM's canvas resize (up) and DeAOT's model-grid resize (down) of a
    uint8 frame against ``cv2.resize`` and the instance-map resize against
    ``INTER_NEAREST``: equal; GroundingDINO's float resize within 1e-4 of
    the pixel range."""
    import cv2

    from vipe_tpu_torch.ops.resize import resize_u8_linear
    from vipe_tpu_torch.priors.track_anything.deaot import model_hw, resize_nearest
    from vipe_tpu_torch.priors.track_anything.gdino import GroundingDINODetector

    rng = np.random.default_rng(hw[0])
    rgb = rng.integers(0, 256, hw + (3,)).astype(np.uint8)
    rgb[hw[0] // 4: hw[0] // 2] = rng.integers(100, 110, (3,))  # a flat band
    s = 128 / max(hw)
    for out in ((int(round(hw[0] * s)), int(round(hw[1] * s))), model_hw(*hw, 96)):
        got = resize_u8_linear(torch.as_tensor(rgb).permute(2, 0, 1)[None], out)[0]
        ref = cv2.resize(rgb, out[::-1]).astype(np.float32)
        assert np.array_equal(got.permute(1, 2, 0).numpy(), ref), (hw, out)
    inst = rng.integers(0, 40, hw).astype(np.int32)
    for out in ((33, 47), model_hw(*hw, 96), (hw[0] * 2 + 1, hw[1] * 3)):
        ref = cv2.resize(inst, out[::-1], interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(resize_nearest(inst, out), ref)
    det = GroundingDINODetector.__new__(GroundingDINODetector)
    det.short_side, det.max_side, det.device = 64, 96, torch.device("cpu")
    got = det.preprocess(rgb)[0].permute(1, 2, 0).numpy()
    ref = cv2.resize(rgb.astype(np.float32), got.shape[1::-1]) / 255.0
    ref = (ref - np.asarray([0.485, 0.456, 0.406])) / np.asarray([0.229, 0.224, 0.225])
    assert np.abs(got - ref).max() * 0.229 < 1e-4


def test_mask_resize_matches_jax():
    """SAM's logit resizes (``jax.image.resize`` bilinear): 4× up to the
    canvas, and down to a smaller frame (antialiased)."""
    from vipe_tpu_torch.ops.resize import resize_bilinear

    x = np.random.default_rng(3).standard_normal((2, 24, 24)).astype(np.float32)
    for out in ((96, 96), (50, 61)):
        ref = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + out, "bilinear"))
        got = resize_bilinear(torch.as_tensor(x)[:, None], out)[:, 0].numpy()
        assert np.abs(got - ref).max() < 1e-5


# ------------------------------------------------- the nets and their hosts


def test_sam_encoder_and_decoder_match_jax():
    sam = _port_sam()
    with torch.no_grad():
        emb = sam.net.image_encoder(torch.as_tensor(_canvas()).permute(0, 3, 1, 2))
        boxes = torch.as_tensor(BOXES.reshape(-1, 2, 2))
        emb4 = emb.expand(len(BOXES), -1, -1, -1)
        masks, iou = sam.net.decode(emb4, boxes)
        masks2, iou2 = sam.net.decode(emb4, boxes, masks[:, 1])
    ref = _JAX_NETS.result("nets")
    errs = {"embedding": _rel(ref["sam_embed"], emb.permute(0, 2, 3, 1).numpy())}
    for name, r, g in zip(("masks", "iou", "masks_refined", "iou_refined"), ref["sam_decode"],
                          (masks, iou, masks2, iou2)):
        errs[name] = _rel(r, g.numpy())
    print("SAM:", {k: f"{v:.3g}" for k, v in errs.items()})
    assert max(errs.values()) < NET_RTOL


def test_sam_predictor_matches_jax():
    """``segment_with_boxes`` and ``segment_composite`` on a frame: the masks
    equal where the logit passes the tolerance, the composite's ids equal."""
    sam = _port_sam()
    sam.set_image(_frames()[0])
    logits = sam.mask_logits(sam.canvas_boxes(BOXES)).numpy()
    masks = sam.segment_with_boxes(BOXES)
    inst, ids = sam.segment_composite(BOXES, SAM_MIN_AREA, 5)
    ref = _JAX_NETS.result("nets")
    assert masks.shape == ref["sam_masks"].shape == (len(BOXES), H, W)
    _held_where_decided(ref["sam_masks"], masks, np.abs(logits), "SAM masks")
    ref_inst, ref_ids = ref["sam_composite"]
    areas = masks.sum((1, 2))
    assert (np.abs(areas - SAM_MIN_AREA) > (ref["sam_masks"] != masks).sum()).all()
    assert list(ids) == list(ref_ids) and (ids > 0).any() and (ids == 0).any(), (ids, areas)
    assert np.array_equal(inst, ref_inst)


def test_bert_and_swin_match_jax():
    det = _port_gdino()
    _, ids_pad, m3, pid, _ = _text_inputs()
    with torch.no_grad():
        text = det.net.bert(torch.as_tensor(ids_pad), torch.as_tensor(m3), torch.as_tensor(pid))
        feats = det.net.backbone[0](det.preprocess(_frames()[0]))
    ref = _JAX_NETS.result("nets")
    errs = [_rel(ref["bert"], text.numpy())]
    errs += [_rel(r, f.permute(0, 2, 3, 1).numpy()) for r, f in zip(ref["swin"], feats)]
    print("BERT, Swin stages:", [f"{e:.3g}" for e in errs])
    assert len(feats) == 3 and max(errs) < NET_RTOL


def test_ms_deform_attn_matches_jax():
    from vipe_tpu_torch.priors.track_anything.gdino.msda import ms_deform_attn

    value, shapes, loc, w = _msda_case()
    got = ms_deform_attn(*(torch.as_tensor(a) for a in (value,)), shapes, torch.as_tensor(loc),
                         torch.as_tensor(w)).numpy()
    ref = _JAX_NETS.result("nets")["msda"]
    assert ((loc < 0) | (loc > 1)).any()
    assert got.shape == ref.shape and np.abs(got - ref).max() < MSDA_TOL


def test_gdino_model_matches_jax():
    det = _port_gdino()
    ids, ids_pad, m3, pid, tmask = _text_inputs()
    args = [det.preprocess(_frames()[0])] + [torch.as_tensor(a) for a in (ids_pad, m3, pid,
                                                                          tmask)]
    with torch.no_grad():
        logits, boxes = det.net(*args)
    ref_logits, ref_boxes = _JAX_NETS.result("nets")["gdino"]
    L = len(ids)
    errs = (_rel(ref_logits[..., :L], logits.numpy()[..., :L]), _rel(ref_boxes, boxes.numpy()))
    print(f"GroundingDINO logits {errs[0]:.3g}, boxes {errs[1]:.3g}")
    assert (logits.numpy()[..., L:] == -1e9).all() and max(errs) < NET_RTOL


@pytest.mark.parametrize("cap", [100, 5])
def test_run_grounding_matches_jax(cap):
    """The kept boxes (threshold 0.35, then the cap by score) and their
    phrases: equal sets where every score is clear of the threshold and of
    the cap's cut; the boxes within the tolerance."""
    det = _port_gdino(box_threshold=0.35, max_detections=cap)
    probs, _, _ = det.forward(_frames()[0], PHRASES)
    boxes, names = det.run_grounding(_frames()[0], PHRASES, return_phrases=True)
    ref_boxes, ref_names = _JAX_NETS.result("nets")["grounding", cap]
    scores = np.sort(probs.max(-1))[::-1]
    cut = [0.35] + ([scores[cap - 1: cap + 1].mean()] if len(scores) > cap else [])
    margin = min(np.abs(scores[:, None] - np.asarray(cut)).min(), 1.0)
    print(f"cap {cap}: {len(boxes)} boxes kept, score margin {margin:.3g}")
    assert margin > NET_RTOL and 0 < len(boxes) <= cap
    assert names == ref_names and len(boxes) == len(ref_boxes)
    assert np.abs(np.asarray(boxes) - np.asarray(ref_boxes)).max() < NET_RTOL * max(H, W)


def test_deaot_net_matches_jax():
    """The reference step's memories and the propagation step's logits."""
    tr = _port_deaot()
    frames = _frames()
    img = tr.preprocess(frames[0])
    mems, _ = tr.reference_memories(img, tr.slots(_instance(), img.shape[-2:]))
    tr.restart()
    tr.add_reference(frames[0], _instance())
    logits = tr.propagate_logits(tr.preprocess(frames[1]))[0]
    ref = _JAX_PIPE.result("pipeline")
    errs = [_rel(r, g.numpy()) for rm, m in zip(ref["deaot_ref"], mems) for r, g in zip(rm, m)]
    errs.append(_rel(ref["deaot_logits"], logits.permute(0, 2, 3, 1).numpy()))
    print("DeAOT memories and logits:", [f"{e:.3g}" for e in errs])
    assert max(errs) < NET_RTOL


def test_deaot_tracker_matches_jax():
    """Two references and three propagations: the maps equal where the
    top-2 logit margin passes the tolerance; the id ↔ slot tables equal;
    ids past the slots dropped alike."""
    from vipe_tpu_torch.ops.resize import resize_align_corners

    tr = _port_deaot()
    frames = _frames()
    tr.restart()
    tr.add_reference(frames[0], _instance())
    seq, margins = [], []
    for k, update in ((1, True), (2, True), (3, False), (4, True)):
        if k == 4:
            tr.add_reference(frames[3], seq[-1])
        full = resize_align_corners(tr.propagate_logits(tr.preprocess(frames[k]))[0], (H, W))
        top2 = torch.topk(full[0], 2, 0)[0]
        margins.append((top2[0] - top2[1]).numpy())
        seq.append(tr.propagate(frames[k], update_memory=update))
    ref_seq, ref_slots = _JAX_PIPE.result("pipeline")["deaot_track"]
    assert dict(tr.slot_to_id) == ref_slots == {1: 3, 2: 7}
    for k, (r, g, m) in enumerate(zip(ref_seq, seq, margins)):
        _held_where_decided(r, g, m, f"DeAOT propagation {k}")
    tr.restart()
    tr.add_reference(frames[0], _overflow_instance())
    ref_table, ref_map = _JAX_PIPE.result("pipeline")["deaot_overflow"]
    assert dict(tr.slot_to_id) == ref_table and len(ref_table) == tr.cfg.max_obj_num
    assert set(np.unique(tr.propagate(frames[1]))) <= set(ref_table.values()) | {0}
    assert set(np.unique(ref_map)) <= set(ref_table.values()) | {0}


# ------------------------------------------------------- the slice as a whole


def test_track_anything_pipeline_matches_jax():
    """Five frames with ``sam_gap`` 2 (detections at frames 0, 2 and 4, the
    merge of new objects, DeAOT in between): every instance map and id →
    phrase map equal to the JAX package's, with at least one instance."""
    pipe = _port_track_anything()
    got = [pipe.track(k, f) for k, f in enumerate(_frames())]
    ref = _JAX_PIPE.result("pipeline")["track"]
    counts = []
    for k, ((inst, phrases), (ref_inst, ref_phrases)) in enumerate(zip(got, ref)):
        assert inst.shape == (H, W) and inst.dtype == ref_inst.dtype
        assert np.array_equal(inst, ref_inst), (k, int((inst != ref_inst).sum()))
        assert phrases == ref_phrases, k
        counts.append(len(phrases))
    print("instances per frame:", counts)
    assert max(counts) >= 1


def test_processor_in_pipeline_matches_jax():
    """``DefaultAnnotationPipeline`` with ``init.instance: track_anything``
    on the CPU (``_run_pipeline``): the frames' masks SLAM reads, the mask
    artifacts, the phrase file and the artifact tree (the visualization
    included) equal to the JAX package's."""
    tree, masks, entries, phrases = _run_pipeline("port")
    ref_tree, ref_masks, ref_entries, ref_phrases = _JAX_PIPE.result("pipeline")["pipeline"]
    assert tree == ref_tree and "mask/clip.zip" in tree and "vipe/clip_vis.mp4" in tree
    assert len(masks) == len(ref_masks) == N_TRACK
    for m, r in zip(masks, ref_masks):
        assert m.dtype == r.dtype == bool and np.array_equal(m, r)
    assert len(entries) == N_TRACK and all(np.array_equal(a, b)
                                           for a, b in zip(entries, ref_entries))
    assert any(e.any() for e in entries) and not all(m.all() for m in masks)
    assert phrases == ref_phrases and phrases


def test_rig_with_instance_raises():
    """A rig with ``init.instance`` is refused before any work: the JAX
    package gives every view one tracker."""
    from vipe_tpu_torch.pipeline.default import DefaultAnnotationPipeline
    from vipe_tpu_torch.streams.base import MultiviewVideoList, VideoStream

    class Unread(VideoStream):
        def __len__(self):
            return N_TRACK

        def __iter__(self):
            raise AssertionError("a frame was read")

    pipe = DefaultAnnotationPipeline(device="cpu", init={"instance": "track_anything",
                                                         "phrases": PHRASES})
    rig = np.tile(np.asarray([0, 0, 0, 0, 0, 0, 1], np.float32), (2, 1))
    with pytest.raises(NotImplementedError, match="rig"):
        pipe.run(MultiviewVideoList("rig", [Unread(), Unread()], rig))


@pytest.mark.parametrize("case", ["seeded_with_zeros", "constant"])
def test_colorize_inv_depth_equals_matplotlib_turbo(case, monkeypatch):
    """The depth pane bit for bit as the JAX package colours it through
    matplotlib's turbo map, with matplotlib unimportable for the port's
    call: seeded depths with holes (no depth: black), and a constant map
    (every value at the stretch's floor)."""
    import sys

    from vipe_tpu.utils import visualization as jviz
    from vipe_tpu_torch.utils import visualization as viz

    rng = np.random.default_rng(8)
    if case == "constant":
        depth = np.full((H, W), 2.5, np.float32)
    else:
        depth = (0.5 + 4 * rng.random((H, W))).astype(np.float32)
        depth[rng.random((H, W)) < 0.1] = 0.0
    ref = jviz.colorize_inv_depth(depth)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = viz.colorize_inv_depth(depth)
    assert got.dtype == ref.dtype == np.uint8 and np.array_equal(got, ref)


def test_turbo_lookup_equals_matplotlib():
    """The carried turbo table is matplotlib's, and its lookup matches
    ``ListedColormap``'s at every bin edge, just below each, at 0 and 1.0,
    outside [0, 1] and on NaN, in f32 and f64."""
    import matplotlib
    from matplotlib._cm_listed import _turbo_data

    from vipe_tpu_torch.utils import visualization as viz

    np.testing.assert_array_equal(viz._TURBO, np.asarray(_turbo_data))
    edges = np.arange(257) / 256
    x = np.concatenate([edges, np.nextafter(edges[1:], 0), [-0.5, 1.5, np.nan],
                        np.random.default_rng(9).random(500)])
    for dtype in (np.float32, np.float64):
        xs = x.astype(dtype)
        ref = (matplotlib.colormaps["turbo"](xs)[..., :3] * 255).astype(np.uint8)
        assert np.array_equal(viz.turbo_u8(xs), ref), dtype


def test_visualization_panes_match_jax():
    """The rgb, instance and depth panes of one frame equal the JAX
    package's."""
    from vipe_tpu.utils import visualization as jviz
    from vipe_tpu_torch.streams.base import VideoFrame
    from vipe_tpu_torch.utils import visualization as viz

    depth = (1.0 + np.random.default_rng(2).random((H, W))).astype(np.float32)
    frame = VideoFrame(raw_frame_idx=0, rgb=_frames()[0], instance=_instance(),
                       metric_depth=depth)
    got = viz.render_projection_frame(frame, 0, None, ("rgb", "instance", "depth"))
    assert got.shape == (H, 3 * W, 3)
    assert np.array_equal(got, jviz.render_projection_frame(frame, 0, None,
                                                            ("rgb", "instance", "depth")))
