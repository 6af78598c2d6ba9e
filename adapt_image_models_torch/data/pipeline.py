"""Sample processor: interprets mmaction-style pipeline configs (parity:
``adapt_image_models_tpu/data/pipeline.py``).

The reference expresses preprocessing as a ``Compose`` of registered
transforms over a results dict (``pipelines/compose.py:9``). Here the same
config lists (so reference configs port verbatim) are *compiled* once into a
``SampleProcessor`` with two stages:

* host stage (this module): decode + sampling + variable-shape geometry
  (short-side resize, crop, fixed resize, flip) -> fixed-shape uint8
  ``(V, T, H, W, C)`` clips
* device stage (``transforms.make_prepare_fn``): normalize + NCTHW format +
  dtype cast, on the model's device

Normalize/FormatShape/Collect/ToTensor entries are parsed for their
parameters but execute on device — the reference's ``GPUNormalize`` idea
(``utils/module_hooks.py:35``) applied to the whole tail.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from adapt_image_models_torch.data import transforms_host as TH
from adapt_image_models_torch.data.audio import AudioSampleProcessor, is_audio_pipeline
from adapt_image_models_torch.data.sampling import SampleFrames
from adapt_image_models_torch.data.video_reader import open_video

_DECODE_INITS = ("DecordInit", "OpenCVInit", "PyAVInit", "FusedDecordInit")
_DECODE_OPS = ("DecordDecode", "OpenCVDecode", "PyAVDecode", "RawFrameDecode",
               "ImageDecode", "FrameSelector")  # FrameSelector: legacy alias
                                                # of RawFrameDecode
                                                # (loading.py:1451)
# 'Fuse' is the reference's lazy-op materializer (augmentations.py:466):
# its lazy crop/flip bookkeeping is consciously superseded by this module's
# two-stage design (host bbox math compiled separately from the pixel ops),
# so the step is accepted as a no-op for config parity. 'Rename' /
# 'ToDataContainer' / 'ImageToTensor' only shuffle the torch runner's
# results-dict plumbing (formatting.py) — nothing to do here.
_NOOPS = ("Collect", "ToTensor", "FormatShape", "Fuse", "Rename",
          "ToDataContainer", "ImageToTensor")


@dataclasses.dataclass
class SampleProcessor:
    """Compiled per-sample host pipeline."""

    sampler: SampleFrames
    steps: List[Tuple[str, Dict[str, Any]]]
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    to_bgr: bool
    test_mode: bool
    io_backend: str = "auto"
    decode_short_side: Optional[int] = None
    # FusedDecordInit fast_rrc/fast_msc/fast_rcc (loading.py:1678-1753):
    # dict(mode='rrc'|'msc'|'rcc', size=int, scale=(lo, hi), hflip=float).
    # Crop geometry is drawn per clip on the host; pixels go through the
    # C++ decoder's fused crop+scale(+flip), with a host cv2 fallback.
    fused_crop: Optional[Dict[str, Any]] = None

    @property
    def num_views(self) -> int:
        """Total views per sample = temporal clips x spatial crops."""
        crops = 1
        for name, kw in self.steps:
            if name == "ThreeCrop":
                crops = 3
            elif name == "TenCrop":
                crops = 10
            elif name == "MultiGroupCrop":
                crops = kw.get("groups", 1)
        if self.sampler.views is None:  # untrimmed: video-dependent
            return None
        return self.sampler.views * crops

    def output_size(self) -> Tuple[int, int]:
        """Final (H, W) after the chain (static: every batch has one shape)."""
        size = None
        for name, kw in self.steps:
            if name == "Resize" and not kw.get("keep_ratio_short", False):
                size = kw["size"]
            elif name in ("CenterCrop", "RandomCrop", "ThreeCrop", "TenCrop",
                          "MultiGroupCrop"):
                size = kw["crop_size"]
            elif name in ("RandomResizedCrop", "MultiScaleCrop",
                          "RandomRescale", "RandomScale"):
                size = None  # followed by a fixed resize/crop in valid configs
        if size is None and self.fused_crop is not None:
            size = (self.fused_crop["size"], self.fused_crop["size"])
        if size is None:
            raise ValueError("pipeline does not end at a fixed spatial size")
        return size

    def __call__(self, source, label, rng: Optional[np.random.Generator] = None,
                 total_frames: Optional[int] = None,
                 start_index: int = 0) -> Tuple[np.ndarray, Any]:
        """source: path / VideoReader. Returns ((V, T, H, W, C) uint8, label)."""
        if rng is None:
            rng = np.random.default_rng()
        reader = open_video(source, short_side=self.decode_short_side,
                            backend=self.io_backend)
        try:
            nf = total_frames or reader.num_frames
            inds = self.sampler(nf, start_index=start_index, rng=rng)
            t = self.sampler.clip_len
            if self.fused_crop is not None:
                clips = self._fused_decode(reader, inds, rng)
            else:
                frames = reader.get_frames(inds)  # (V*T, H, W, C)
                clips = frames.reshape(-1, t, *frames.shape[1:])
        finally:
            if reader is not source:
                reader.close()

        # Flip steps with a flip_label_map (direction-sensitive classes,
        # reference augmentations.py Flip.flip_label_map) decide ONCE per
        # sample — every clip flips together and the label remaps with them
        flip_override = None
        for i, (name, kw) in enumerate(self.steps):
            if (name == "Flip" and kw.get("flip_label_map")
                    and not self.test_mode):
                ratio = kw.get("flip_ratio", 0.5)
                do = bool(ratio) and rng.random() < ratio
                flip_override = flip_override or {}
                flip_override[i] = do
                if do:
                    label = kw["flip_label_map"].get(label, label)

        out_clips = []
        for clip in clips:
            out_clips.extend(self._apply_spatial(clip, rng,
                                                 flip_override=flip_override))
        out = np.stack(out_clips, axis=0)
        if self.to_bgr:
            out = out[..., ::-1]
        return np.ascontiguousarray(out), label

    # ------------------------------------------------------------------
    def _fused_bbox(self, hw: Tuple[int, int],
                    rng: np.random.Generator) -> Tuple[int, int, int, int]:
        f = self.fused_crop
        if f["mode"] == "rrc":
            return TH.random_resized_crop_bbox(rng, hw,
                                               area_range=f["scale"])
        if f["mode"] == "msc":
            return TH.multi_scale_crop_bbox(
                rng, hw, input_size=(f["size"], f["size"]))
        # rcc: short-side resize to `size` + center crop `size` == center
        # square of side min(H, W) scaled to (size, size), in one resample
        h, w = hw
        m = min(h, w)
        x, y = (w - m) // 2, (h - m) // 2
        return x, y, x + m, y + m

    def _fused_decode(self, reader, inds: np.ndarray,
                      rng: np.random.Generator) -> np.ndarray:
        """FusedDecordInit fast path -> (V, T, size, size, C) uint8."""
        f = self.fused_crop
        t = self.sampler.clip_len
        size = (f["size"], f["size"])
        views = len(inds) // t
        hflip = f.get("hflip", 0.0) if not self.test_mode else 0.0

        fast = getattr(reader, "get_frames_crop", None)
        if fast is not None and self.decode_short_side is None:
            hw = (reader.height, reader.width)
            clips = []
            for v in range(views):
                bbox = self._fused_bbox(hw, rng)
                do_flip = bool(hflip) and rng.random() < hflip
                got = fast(inds[v * t:(v + 1) * t], bbox, size, do_flip)
                if got is None:  # exotic pixel format: host fallback
                    break
                clips.append(got)
            else:
                return np.stack(clips, axis=0)

        # host fallback (OpenCV/synthetic readers or unsupported pix_fmt):
        # native decode, then identical crop geometry + cv2 resize + flip
        frames = reader.get_frames(inds)
        hw = frames.shape[1:3]
        clips = []
        for v in range(views):
            bbox = self._fused_bbox(hw, rng)
            x0, y0, x1, y1 = bbox
            clip = frames[v * t:(v + 1) * t, y0:y1, x0:x1]
            clip = TH.resize_clip(clip, size[::-1])
            if bool(hflip) and rng.random() < hflip:
                clip = TH.flip_clip(clip)
            clips.append(clip)
        return np.stack(clips, axis=0)

    # ------------------------------------------------------------------
    def _apply_spatial(self, clip: np.ndarray,
                       rng: np.random.Generator,
                       flip_override=None) -> List[np.ndarray]:
        """One temporal clip (T, H, W, C) -> list of spatial-view clips."""
        views = [clip]
        for step_i, (name, kw) in enumerate(self.steps):
            new_views = []
            for v in views:
                hw = v.shape[1:3]
                if name == "Resize":
                    if kw.get("keep_ratio_short", False):
                        new_views.append(TH.rescale_short_side(v, kw["short_side"]))
                    else:
                        h, w = kw["size"]
                        new_views.append(TH.resize_clip(v, (w, h)))
                elif name == "RandomResizedCrop":
                    bbox = TH.random_resized_crop_bbox(
                        rng, hw, kw.get("area_range", (0.08, 1.0)),
                        kw.get("aspect_ratio_range", (3 / 4, 4 / 3)))
                    new_views.append(TH.crop_clip(v, bbox))
                elif name == "MultiScaleCrop":
                    bbox = TH.multi_scale_crop_bbox(
                        rng, hw, input_size=kw["crop_size"][::-1],
                        scales=kw.get("scales", (1.0, 0.875, 0.75, 0.66)),
                        max_wh_scale_gap=kw.get("max_wh_scale_gap", 1),
                        random_crop=kw.get("random_crop", False))
                    new_views.append(TH.crop_clip(v, bbox))
                elif name == "CenterCrop":
                    ch, cw = kw["crop_size"]
                    bbox = TH.center_crop_bbox(hw, (cw, ch))
                    new_views.append(TH.crop_clip(v, bbox))
                elif name == "RandomCrop":
                    ch, cw = kw["crop_size"]
                    bbox = TH.random_crop_bbox(rng, hw, (cw, ch))
                    new_views.append(TH.crop_clip(v, bbox))
                elif name == "ThreeCrop":
                    ch, cw = kw["crop_size"]
                    for (x, y) in TH.three_crop_offsets(hw, (cw, ch)):
                        new_views.append(v[:, y:y + ch, x:x + cw])
                elif name == "TenCrop":
                    ch, cw = kw["crop_size"]
                    for (x, y) in TH.ten_crop_offsets(hw, (cw, ch)):
                        c = v[:, y:y + ch, x:x + cw]
                        new_views.append(c)
                        new_views.append(TH.flip_clip(c))
                elif name == "MultiGroupCrop":
                    ch, cw = kw["crop_size"]
                    for _ in range(kw.get("groups", 1)):
                        bbox = TH.random_crop_bbox(rng, hw, (cw, ch))
                        new_views.append(TH.crop_clip(v, bbox))
                elif name == "RandomRescale":
                    lo, hi = kw["scale_range"]
                    short = int(rng.integers(lo, hi + 1))
                    new_views.append(TH.rescale_short_side(v, short))
                elif name == "RandomScale":
                    scales = kw["scales"]
                    if len(scales) == 1:
                        scale = scales[0]
                    elif len(scales) == 2 and kw.get("mode",
                                                     "range") == "range":
                        longs = [max(s) for s in scales]
                        shorts = [min(s) for s in scales]
                        scale = (int(rng.integers(min(longs),
                                                  max(longs) + 1)),
                                 int(rng.integers(min(shorts),
                                                  max(shorts) + 1)))
                    else:
                        scale = scales[int(rng.integers(len(scales)))]
                    # mmcv rescale semantics: fit within (long, short)
                    # keeping aspect ratio (reference augmentations.py:510
                    # -> Resize keep_ratio=True)
                    long_e, short_e = max(scale), min(scale)
                    h0, w0 = hw
                    f = min(long_e / max(h0, w0), short_e / min(h0, w0))
                    new_views.append(TH.resize_clip(
                        v, (max(1, int(w0 * f + 0.5)),
                            max(1, int(h0 * f + 0.5)))))
                elif name == "Flip":
                    if flip_override and step_i in flip_override:
                        do = flip_override[step_i]
                    else:
                        ratio = kw.get("flip_ratio", 0.5)
                        do = (not self.test_mode and ratio
                              and rng.random() < ratio)
                    new_views.append(TH.flip_clip(v) if do else v)
                elif name == "BuildPseudoClip":
                    # single image -> clip_len repeats (loading.py:1422;
                    # OmniSource web-image sources feeding 3D recognizers)
                    if v.shape[0] != 1:
                        raise ValueError("BuildPseudoClip expects single-"
                                         f"frame clips, got T={v.shape[0]}")
                    new_views.append(np.repeat(v, kw["clip_len"], axis=0))
                elif name == "RandAugment":
                    from adapt_image_models_torch.data.randaugment import rand_augment
                    new_views.append(rand_augment(rng, v, n=kw.get("n", 4),
                                                  m=kw.get("m", 7)))
                elif name == "ImgaugOps":
                    from adapt_image_models_torch.data.randaugment import imgaug_ops
                    new_views.append(imgaug_ops(
                        rng, v, [dict(s) for s in kw["specs"]]))
                elif name == "RandomErasing":
                    from adapt_image_models_torch.data.randaugment import random_erasing
                    new_views.append(random_erasing(
                        rng, v, probability=kw.get("probability", 0.25)))
                elif name == "ColorJitter":
                    from adapt_image_models_torch.data.randaugment import color_jitter
                    new_views.append(color_jitter(
                        rng, v, brightness=kw.get("brightness", 0.5),
                        contrast=kw.get("contrast", 0.5),
                        saturation=kw.get("saturation", 0.5)))
                else:
                    raise ValueError(f"unhandled spatial step {name}")
            views = new_views
        return views


def _pair(x) -> Tuple[int, int]:
    if isinstance(x, (tuple, list)):
        return int(x[0]), int(x[1])
    return int(x), int(x)


def build_sample_processor(pipeline_cfg: Sequence[Dict[str, Any]],
                           test_mode: Optional[bool] = None,
                           io_backend: str = "auto"):
    """Compile an mmaction-style pipeline config list: a ``SampleProcessor``,
    or an audio pipeline's ``AudioSampleProcessor``."""
    if is_audio_pipeline(pipeline_cfg):
        return AudioSampleProcessor(pipeline_cfg)
    sampler = None
    steps: List[Tuple[str, Dict[str, Any]]] = []
    mean, std, to_bgr = (122.769, 116.74, 104.04), (68.493, 66.63, 70.321), False
    fused_short_side = None
    fused_crop = None

    for item in pipeline_cfg:
        item = dict(item)
        t = item.pop("type")
        if t in _DECODE_INITS:
            if t == "FusedDecordInit":
                # the fork's patched-decord fused decode (loading.py:1678-
                # 1753): in-decoder crop+scale(+hflip) for rrc/msc/rcc
                if float(item.get("vflip_prob", 0.0)):
                    raise ValueError("FusedDecordInit vflip_prob is not "
                                     "supported (no reference config uses it)")
                hflip = float(item.get("hflip_prob", 0.0))
                if item.get("fast_rrc"):
                    s, scale = item.get("rrc_params", (224, (0.5, 1.0)))
                    fused_crop = dict(mode="rrc", size=int(s),
                                      scale=tuple(scale), hflip=hflip)
                elif item.get("fast_msc"):
                    s = item.get("msc_params", (224,))[0]
                    fused_crop = dict(mode="msc", size=int(s), hflip=hflip)
                elif item.get("fast_rcc"):
                    s = item.get("cc_params", (224,))[0]
                    fused_crop = dict(mode="rcc", size=int(s), hflip=hflip)
                else:
                    # fused decode+resize: honor the short-side hint
                    sc = item.get("scale") or item.get("short_side")
                    if sc:
                        fused_short_side = int(
                            sc if np.isscalar(sc) else max(sc))
            continue
        if t in _DECODE_OPS or t in _NOOPS:
            continue
        if t == "UntrimmedSampleFrames":
            # per-video variable clip count: valid for per-video tools
            # (clip_feature_extraction, LFB inference), not batch loaders
            from adapt_image_models_torch.data.sampling import (
                UntrimmedSampleFrames)
            test_mode = True if test_mode is None else test_mode
            sampler = UntrimmedSampleFrames(
                clip_len=item["clip_len"],
                frame_interval=item.get("frame_interval", 16),
                start_index=item.get("start_index", 0))
            continue
        if t == "DenseSampleFrames":
            # dense sampling inside a 64-frame window (reference
            # loading.py:341) — previously this silently degraded to
            # uniform SampleFrames
            from adapt_image_models_torch.data.sampling import (
                DenseSampleFrames)
            item.setdefault("test_mode", False)
            if test_mode is None:
                test_mode = item["test_mode"]
            sampler = DenseSampleFrames(
                clip_len=item["clip_len"],
                frame_interval=item.get("frame_interval", 1),
                num_clips=item.get("num_clips", 1),
                sample_range=item.get("sample_range", 64),
                num_sample_positions=item.get("num_sample_positions", 10),
                test_mode=item["test_mode"])
            continue
        if t == "SampleFrames":
            item.setdefault("test_mode", False)
            if test_mode is None:
                test_mode = item["test_mode"]
            sampler = SampleFrames(
                clip_len=item["clip_len"],
                frame_interval=item.get("frame_interval", 1),
                num_clips=item.get("num_clips", 1),
                temporal_jitter=item.get("temporal_jitter", False),
                twice_sample=item.get("twice_sample", False),
                out_of_bound_opt=item.get("out_of_bound_opt", "loop"),
                test_mode=item["test_mode"],
                frame_uniform=item.get("frame_uniform", False))
            continue
        if t == "Normalize":
            mean = tuple(item.get("mean", mean))
            std = tuple(item.get("std", std))
            to_bgr = bool(item.get("to_bgr", False))
            continue
        if t == "Resize":
            scale = item["scale"]
            keep_ratio = item.get("keep_ratio", True)
            if isinstance(scale, (tuple, list)) and -1 in tuple(scale):
                steps.append(("Resize", dict(keep_ratio_short=True,
                                             short_side=int(max(scale)))))
            elif keep_ratio and not isinstance(scale, (tuple, list)):
                raise ValueError("float rescale not supported; use (-1, N)")
            else:
                w, h = _pair(scale)
                steps.append(("Resize", dict(keep_ratio_short=False,
                                             size=(h, w))))
            continue
        if t in ("CenterCrop", "RandomCrop", "ThreeCrop", "TenCrop"):
            # reference RandomCrop spells its crop size 'size'
            # (augmentations.py:578); the others use 'crop_size'
            cs = item["size"] if "size" in item else item["crop_size"]
            ch, cw = (_pair(cs)[::-1] if isinstance(cs, (tuple, list))
                      else _pair(cs))
            steps.append((t, dict(crop_size=(ch, cw))))
            continue
        if t == "RandomResizedCrop":
            steps.append((t, dict(
                area_range=tuple(item.get("area_range", (0.08, 1.0))),
                aspect_ratio_range=tuple(item.get("aspect_ratio_range",
                                                  (3 / 4, 4 / 3))))))
            continue
        if t == "MultiGroupCrop":
            cw, ch = _pair(item["crop_size"])  # reference order: (w, h)
            steps.append((t, dict(crop_size=(ch, cw),
                                  groups=int(item.get("groups", 1)))))
            continue
        if t == "RandomRescale":
            steps.append((t, dict(
                scale_range=tuple(item["scale_range"]))))
            continue
        if t == "RandomScale":
            steps.append((t, dict(
                scales=tuple(tuple(s) if isinstance(s, (tuple, list))
                             else (s, s) for s in item["scales"]),
                mode=item.get("mode", "range"))))
            continue
        if t == "MultiScaleCrop":
            steps.append((t, dict(
                crop_size=_pair(item["input_size"]),
                scales=tuple(item.get("scales", (1.0, 0.875, 0.75, 0.66))),
                max_wh_scale_gap=item.get("max_wh_scale_gap", 1),
                random_crop=item.get("random_crop", False))))
            continue
        if t == "PytorchVideoWrapper":
            # reference augmentations.py:2086 wraps pytorchvideo transforms;
            # its RandAugment use maps onto the native implementation
            op = item.get("op")
            if op == "RandAugment":
                steps.append(("RandAugment",
                              dict(n=int(item.get("num_layers", 4)),
                                   m=int(item.get("magnitude", 7)))))
                continue
            raise ValueError(
                f"unsupported PytorchVideoWrapper op {op!r} (RandAugment "
                "is supported natively; AugMix has no equivalent here)")
        if t == "BuildPseudoClip":
            steps.append((t, dict(clip_len=int(item["clip_len"]))))
            continue
        if t == "Flip":
            steps.append((t, dict(flip_ratio=item.get("flip_ratio", 0.5),
                                  flip_label_map=item.get("flip_label_map"))))
            continue
        if t == "Imgaug":
            # the reference wraps imgaug; its uses map onto the native
            # RandAugment: explicit RandAugment entries
            # (vitclip_base_sthv2.py:25) and transforms='default', which IS
            # RandAugment with n=2, magnitude 9/10
            # (augmentations.py:282-301, the tsm/tanet recipes)
            transforms = item.get("transforms", [])
            if transforms == "default":
                steps.append(("RandAugment", dict(n=2, m=9)))
                continue
            imgaug_specs = []

            def _flush_imgaug():
                if imgaug_specs:
                    steps.append(("ImgaugOps", dict(specs=tuple(
                        tuple(sorted(s.items())) for s in imgaug_specs))))
                    imgaug_specs.clear()

            for tr in transforms:
                if tr.get("type") == "RandAugment":
                    # flush first: a mixed list must keep transform order
                    _flush_imgaug()
                    steps.append(("RandAugment", dict(n=tr.get("n", 4),
                                                      m=tr.get("m", 7))))
                elif tr.get("type") in ("Fliplr", "Rotate", "Dropout"):
                    # the reference's custom imgaug lists
                    # (i3d_r50_video_imgaug...py:25-30)
                    imgaug_specs.append(dict(tr))
                else:
                    raise ValueError(f"unsupported Imgaug transform {tr}")
            _flush_imgaug()
            continue
        if t == "RandomErasing":
            # NOTE: reference erases after Normalize (float noise); we erase
            # uint8 with uniform noise pre-normalize — same distribution role
            steps.append((t, dict(probability=item.get("probability", 0.25))))
            continue
        if t == "ColorJitter":
            steps.append((t, dict(brightness=item.get("brightness", 0.5),
                                  contrast=item.get("contrast", 0.5),
                                  saturation=item.get("saturation", 0.5))))
            continue
        raise ValueError(f"unsupported pipeline transform: {t}")

    if sampler is None:
        raise ValueError("pipeline has no SampleFrames step")
    return SampleProcessor(sampler=sampler, steps=steps, mean=mean, std=std,
                           to_bgr=to_bgr, test_mode=bool(test_mode),
                           io_backend=io_backend,
                           decode_short_side=fused_short_side,
                           fused_crop=fused_crop)
