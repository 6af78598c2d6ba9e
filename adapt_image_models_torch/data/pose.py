"""The PoseC3D data stage (parity: ``adapt_image_models_tpu/data/pose.py``,
a copy in numpy with nothing of JAX): frame sampling, keypoint decoding and
compaction, the geometry of the keypoint coordinates and the pseudo-heatmap
volume.

Reference: ``mmaction/datasets/pipelines/pose_loading.py``
(``UniformSampleFrames:13``, ``PoseDecode:141``, ``GeneratePoseTarget:348``)
and ``augmentations.py:59`` (``PoseCompact``). The reference threads the
keypoints through its image transforms and renders each heatmap with
Python loops over 3-sigma patches; here every geometric step acts on the
(P, T, V, 2) coordinates alone, and the heatmaps are rendered once, at the
final size, by one (persons x keypoints x H x W) broadcast. Limb maps use
the distance to the segment (a clipped projection), which reproduces the
reference's start / end / segment cases.

``PoseSampleProcessor`` compiles a PoseC3D pipeline into one call: an
annotation dict -> ((clips, T, H, W, C) float32 heatmaps, label), which
``PoseDataset.prepare_sample`` runs for the loader.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

COCO_SKELETONS = ((0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (5, 7), (7, 9),
                  (0, 6), (6, 8), (8, 10), (5, 11), (11, 13), (13, 15),
                  (6, 12), (12, 14), (14, 16), (11, 12))
COCO_LEFT_KP = (1, 3, 5, 7, 9, 11, 13, 15)
COCO_RIGHT_KP = (2, 4, 6, 8, 10, 12, 14, 16)
EPS = 1e-4


# ---------------------------------------------------------------- sampling

def uniform_sample_frames(num_frames: int, clip_len: int, num_clips: int = 1,
                          test_mode: bool = False,
                          rng: Optional[np.random.Generator] = None,
                          seed: int = 255) -> np.ndarray:
    """PoseC3D uniform interval sampling (reference
    ``pose_loading.py:40-111``): split into clip_len bins, one random
    (train) or seeded-random (test) index per bin; wraps via mod for short
    videos. Returns (num_clips * clip_len,) indices."""
    if test_mode:
        rng = np.random.default_rng(seed)
    elif rng is None:
        rng = np.random.default_rng()

    def one_clip():
        if num_frames < clip_len:
            if test_mode:
                return None  # handled jointly below (start offsets differ)
            start = int(rng.integers(num_frames))
            return np.arange(start, start + clip_len)
        if num_frames < 2 * clip_len:
            basic = np.arange(clip_len)
            picks = rng.choice(clip_len + 1, num_frames - clip_len,
                               replace=False)
            offset = np.zeros(clip_len + 1, np.int64)
            offset[picks] = 1
            return basic + np.cumsum(offset)[:-1]
        bids = np.array([i * num_frames // clip_len
                         for i in range(clip_len + 1)])
        bsize = np.diff(bids)
        return bids[:clip_len] + rng.integers(bsize)

    if test_mode:
        if num_frames < clip_len:
            if num_frames < num_clips:
                starts = list(range(num_clips))
            else:
                starts = [i * num_frames // num_clips
                          for i in range(num_clips)]
            inds = np.concatenate([np.arange(s, s + clip_len)
                                   for s in starts])
        else:
            inds = np.concatenate([one_clip() for _ in range(num_clips)])
    else:
        if num_clips != 1:
            raise ValueError("train mode supports num_clips=1 (reference "
                             "pose_loading.py:47)")
        inds = one_clip()
    return np.mod(inds, num_frames).astype(np.int64)


def pose_decode(kp: np.ndarray, kpscore: Optional[np.ndarray],
                frame_inds: np.ndarray
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Gather per-frame keypoints (reference ``PoseDecode``,
    ``pose_loading.py:141-196``). kp: (P, T, V, 2)."""
    kp = kp[:, frame_inds].astype(np.float32)
    if kpscore is not None:
        kpscore = kpscore[:, frame_inds].astype(np.float32)
    return kp, kpscore


# ------------------------------------------------------------- compaction

def pose_compact(kp: np.ndarray, img_shape: Tuple[int, int],
                 padding: float = 0.25, threshold: int = 10,
                 hw_ratio: Optional[Tuple[float, float]] = None,
                 allow_imgpad: bool = True
                 ) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Crop to the padded union bounding box of all joints (reference
    ``augmentations.py:59-152``). Returns (shifted kp, new img_shape)."""
    h, w = img_shape
    kp = np.nan_to_num(kp).copy()
    kp_x, kp_y = kp[..., 0], kp[..., 1]
    nz_x, nz_y = kp_x[kp_x != 0], kp_y[kp_y != 0]
    min_x = np.min(nz_x, initial=np.inf)
    min_y = np.min(nz_y, initial=np.inf)
    max_x = np.max(nz_x, initial=-np.inf)
    max_y = np.max(nz_y, initial=-np.inf)
    if max_x - min_x < threshold or max_y - min_y < threshold:
        return kp, img_shape
    cx, cy = (max_x + min_x) / 2, (max_y + min_y) / 2
    half_w = (max_x - min_x) / 2 * (1 + padding)
    half_h = (max_y - min_y) / 2 * (1 + padding)
    if hw_ratio is not None:
        half_h = max(hw_ratio[0] * half_w, half_h)
        half_w = max(1 / hw_ratio[1] * half_h, half_w)
    min_x, max_x = cx - half_w, cx + half_w
    min_y, max_y = cy - half_h, cy + half_h
    if not allow_imgpad:
        min_x, min_y = int(max(0, min_x)), int(max(0, min_y))
        max_x, max_y = int(min(w, max_x)), int(min(h, max_y))
    else:
        min_x, min_y = int(min_x), int(min_y)
        max_x, max_y = int(max_x), int(max_y)
    kp_x[kp_x != 0] -= min_x
    kp_y[kp_y != 0] -= min_y
    return kp, (max_y - min_y, max_x - min_x)


# ---------------------------------------------------- coordinate geometry

def resize_kp(kp: np.ndarray, img_shape: Tuple[int, int],
              new_shape: Tuple[int, int]) -> np.ndarray:
    """Scale coordinates with the image (the keypoint branch of the
    reference ``Resize``)."""
    sy = new_shape[0] / img_shape[0]
    sx = new_shape[1] / img_shape[1]
    return kp * np.array([sx, sy], np.float32)


def random_resized_crop_kp(kp: np.ndarray, img_shape: Tuple[int, int],
                           target: Tuple[int, int],
                           rng: np.random.Generator,
                           area_range: Tuple[float, float] = (0.56, 1.0),
                           aspect_range: Tuple[float, float] = (3 / 4, 4 / 3)
                           ) -> np.ndarray:
    """RandomResizedCrop acting on coordinates only: pick the crop box like
    the image op, shift+scale the keypoints to ``target``."""
    h, w = img_shape
    for _ in range(10):
        area = rng.uniform(*area_range) * h * w
        ar = np.exp(rng.uniform(np.log(aspect_range[0]),
                                np.log(aspect_range[1])))
        cw, ch = int(round(np.sqrt(area * ar))), int(round(np.sqrt(area / ar)))
        if cw <= w and ch <= h:
            x0 = int(rng.integers(0, w - cw + 1))
            y0 = int(rng.integers(0, h - ch + 1))
            break
    else:
        cw, ch = min(w, h), min(w, h)
        x0, y0 = (w - cw) // 2, (h - ch) // 2
    out = kp - np.array([x0, y0], np.float32)
    return resize_kp(out, (ch, cw), target)


def center_crop_kp(kp: np.ndarray, img_shape: Tuple[int, int],
                   crop: Tuple[int, int]) -> np.ndarray:
    h, w = img_shape
    y0, x0 = (h - crop[0]) // 2, (w - crop[1]) // 2
    return kp - np.array([x0, y0], np.float32)


def flip_kp(kp: np.ndarray, img_w: int,
            left_kp: Sequence[int] = COCO_LEFT_KP,
            right_kp: Sequence[int] = COCO_RIGHT_KP) -> np.ndarray:
    """Horizontal flip + left/right channel swap (the keypoint branch of
    the reference ``Flip``, ``augmentations.py:1246``). Only nonzero x
    coordinates flip (``augmentations.py:1301``): x == 0 marks a missing
    keypoint, which must not become a phantom point at ``img_w``."""
    kp = kp.copy()
    nz = kp[..., 0] != 0
    kp[..., 0] = np.where(nz, img_w - kp[..., 0], kp[..., 0])
    order = np.arange(kp.shape[-2])
    for l, r in zip(left_kp, right_kp):
        order[l], order[r] = r, l
    return kp[..., order, :]


# ----------------------------------------------------- heatmap generation

def keypoint_heatmaps(kps: np.ndarray, values: np.ndarray,
                      img_shape: Tuple[int, int],
                      sigma: float = 0.6) -> np.ndarray:
    """(P, T, V, 2) coords + (P, T, V) max values -> (T, H, W, V) gaussian
    maps, max-reduced over persons (vectorized form of reference
    ``generate_a_heatmap``, ``pose_loading.py:404-444``)."""
    h, w = img_shape
    x = np.arange(w, dtype=np.float32)
    y = np.arange(h, dtype=np.float32)
    dx = x[None, None, None, :] - kps[..., 0][..., None]        # (P,T,V,W)
    dy = y[None, None, None, :] - kps[..., 1][..., None]        # (P,T,V,H)
    g = np.exp(-(dy[..., :, None] ** 2 + dx[..., None, :] ** 2)
               / (2 * sigma ** 2))                              # (P,T,V,H,W)
    g = g * values[..., None, None]
    g = np.where(values[..., None, None] < EPS, 0.0, g)
    # initial 0: no person (box_thr kept none) renders zeros, as the
    # reference's loop over no person does (JAX's max raises)
    return g.max(axis=0, initial=0.0).transpose(0, 2, 3, 1).astype(np.float32)


def limb_heatmaps(kps: np.ndarray, values: np.ndarray,
                  img_shape: Tuple[int, int],
                  skeletons: Sequence[Tuple[int, int]] = COCO_SKELETONS,
                  sigma: float = 0.6) -> np.ndarray:
    """(P, T, V, 2) -> (T, H, W, E) limb maps via distance-to-segment
    (vectorized form of reference ``generate_a_limb_heatmap``,
    ``pose_loading.py:446-530``: the clipped projection coefficient
    reproduces its start/end/segment dominate split)."""
    h, w = img_shape
    sk = np.asarray(skeletons)                                   # (E, 2)
    starts = kps[:, :, sk[:, 0]]                                 # (P,T,E,2)
    ends = kps[:, :, sk[:, 1]]
    val = np.minimum(values[:, :, sk[:, 0]], values[:, :, sk[:, 1]])

    x = np.arange(w, dtype=np.float32)[None, None, None, None, :]
    y = np.arange(h, dtype=np.float32)[None, None, None, :, None]
    sx = starts[..., 0][..., None, None]
    sy = starts[..., 1][..., None, None]
    ex = ends[..., 0][..., None, None]
    ey = ends[..., 1][..., None, None]

    d2_ab = (sx - ex) ** 2 + (sy - ey) ** 2                      # (P,T,E,1,1)
    d2_start = (x - sx) ** 2 + (y - sy) ** 2
    d2_end = (x - ex) ** 2 + (y - ey) ** 2
    coeff = np.clip((d2_start - d2_end + d2_ab) / (2 * np.maximum(d2_ab, 1e-6)),
                    0.0, 1.0)
    px = sx + coeff * (ex - sx)
    py = sy + coeff * (ey - sy)
    d2_seg = (x - px) ** 2 + (y - py) ** 2
    # degenerate limb (reference: d2_ab < 1 -> gaussian at start point)
    d2_seg = np.where(d2_ab < 1, d2_start, d2_seg)
    g = np.exp(-d2_seg / (2 * sigma ** 2)) * val[..., None, None]
    g = np.where(val[..., None, None] < EPS, 0.0, g)
    # initial 0: no person (box_thr kept none) renders zeros, as the
    # reference's loop over no person does (JAX's max raises)
    return g.max(axis=0, initial=0.0).transpose(0, 2, 3, 1).astype(np.float32)


def generate_pose_target(kp: np.ndarray, kpscore: Optional[np.ndarray],
                         img_shape: Tuple[int, int], sigma: float = 0.6,
                         use_score: bool = True, with_kp: bool = True,
                         with_limb: bool = False,
                         skeletons: Sequence = COCO_SKELETONS,
                         double: bool = False,
                         left_kp: Sequence[int] = COCO_LEFT_KP,
                         right_kp: Sequence[int] = COCO_RIGHT_KP
                         ) -> np.ndarray:
    """(P, T, V, 2) -> (T, H, W, C) pseudo-heatmap video (reference
    ``GeneratePoseTarget.__call__``, ``pose_loading.py:607-618``; channel
    layout kp-channels then limb-channels). ``double`` concatenates the
    flipped rendering along T like the reference."""
    if not (with_kp or with_limb):
        raise ValueError("at least one of with_kp / with_limb")
    values = (kpscore if (use_score and kpscore is not None)
              else np.ones(kp.shape[:-1], np.float32))
    chunks = []
    if with_kp:
        chunks.append(keypoint_heatmaps(kp, values, img_shape, sigma))
    if with_limb:
        chunks.append(limb_heatmaps(kp, values, img_shape, skeletons, sigma))
    out = np.concatenate(chunks, axis=-1)
    if double:
        kp_f = flip_kp(kp, img_shape[1], left_kp, right_kp)
        val_f = values[..., _flip_order(kp.shape[-2], left_kp, right_kp)]
        chunks_f = []
        if with_kp:
            chunks_f.append(keypoint_heatmaps(kp_f, val_f, img_shape, sigma))
        if with_limb:
            chunks_f.append(limb_heatmaps(kp_f, val_f, img_shape, skeletons,
                                          sigma))
        out = np.concatenate([out, np.concatenate(chunks_f, axis=-1)], axis=0)
    return out


def _flip_order(num_kp: int, left_kp: Sequence[int],
                right_kp: Sequence[int]) -> np.ndarray:
    order = np.arange(num_kp)
    for l, r in zip(left_kp, right_kp):
        order[l], order[r] = r, l
    return order


# ------------------------------------------------------ pipeline processor

class PoseSampleProcessor:
    """Compile a PoseC3D pipeline config into one callable:
    info dict -> (imgs (N_clips, T, H, W, C) float32, label).

    Supported step types (names match the reference configs):
    UniformSampleFrames, PoseDecode, PoseCompact, Resize (short-side or
    fixed), RandomResizedCrop, CenterCrop, Flip, GeneratePoseTarget,
    FormatShape('NCTHW').
    """

    def __init__(self, pipeline: Sequence[Dict[str, Any]]):
        self.steps = [dict(s) for s in pipeline]
        self.clip_len = 1
        self.num_clips = 1
        self.test_mode = False
        self.target_shape: Optional[Tuple[int, int]] = None
        for s in self.steps:
            t = s["type"]
            if t == "UniformSampleFrames":
                self.clip_len = s["clip_len"]
                self.num_clips = s.get("num_clips", 1)
                self.test_mode = s.get("test_mode", False)
            elif t in ("Resize", "RandomResizedCrop", "CenterCrop"):
                scale = s.get("scale", s.get("crop_size"))
                if scale is not None and not (
                        isinstance(scale, (tuple, list)) and scale[0] == -1):
                    sh = (scale, scale) if isinstance(scale, int) else tuple(scale)
                    self.target_shape = (sh[1], sh[0]) \
                        if t == "Resize" else (sh[0], sh[1])

    def output_size(self) -> Tuple[int, int]:
        return self.target_shape or (56, 56)

    @property
    def num_views(self) -> int:
        return self.num_clips

    def __call__(self, info: Dict[str, Any],
                 rng: Optional[np.random.Generator] = None
                 ) -> Tuple[np.ndarray, Any]:
        rng = rng or np.random.default_rng()
        kp = np.asarray(info["keypoint"], np.float32)
        kpscore = info.get("keypoint_score")
        if kpscore is not None:
            kpscore = np.asarray(kpscore, np.float32)
        img_shape = tuple(info["img_shape"])
        total_frames = int(info["total_frames"])
        label = info["label"]
        heat = None

        for s in self.steps:
            t = s["type"]
            if t == "UniformSampleFrames":
                inds = uniform_sample_frames(
                    total_frames, s["clip_len"], s.get("num_clips", 1),
                    s.get("test_mode", False), rng=rng,
                    seed=s.get("seed", 255))
            elif t == "PoseDecode":
                kp, kpscore = pose_decode(kp, kpscore, inds)
            elif t == "PoseCompact":
                hw = s.get("hw_ratio")
                if hw is not None and not isinstance(hw, (tuple, list)):
                    hw = (hw, hw)
                kp, img_shape = pose_compact(
                    kp, img_shape, s.get("padding", 0.25),
                    s.get("threshold", 10), hw,
                    s.get("allow_imgpad", True))
            elif t == "Resize":
                scale = s["scale"]
                if isinstance(scale, (tuple, list)) and scale[0] == -1:
                    ss = scale[1]
                    h, w = img_shape
                    if h < w:
                        new_shape = (ss, int(round(w * ss / h)))
                    else:
                        new_shape = (int(round(h * ss / w)), ss)
                else:
                    sh = (scale, scale) if isinstance(scale, int) else scale
                    new_shape = (sh[1], sh[0])  # cfg is (w, h)
                kp = resize_kp(kp, img_shape, new_shape)
                img_shape = new_shape
            elif t == "RandomResizedCrop":
                target = self.target_shape or img_shape
                kp = random_resized_crop_kp(
                    kp, img_shape, target, rng,
                    s.get("area_range", (0.56, 1.0)))
                img_shape = target
            elif t == "CenterCrop":
                c = s["crop_size"]
                crop = (c, c) if isinstance(c, int) else tuple(c)
                kp = center_crop_kp(kp, img_shape, crop)
                img_shape = crop
            elif t == "Flip":
                if rng.random() < s.get("flip_ratio", 0.5):
                    kp = flip_kp(kp, img_shape[1],
                                 s.get("left_kp", COCO_LEFT_KP),
                                 s.get("right_kp", COCO_RIGHT_KP))
                    if kpscore is not None:
                        kpscore = kpscore[..., _flip_order(
                            kp.shape[-2], s.get("left_kp", COCO_LEFT_KP),
                            s.get("right_kp", COCO_RIGHT_KP))]
            elif t == "GeneratePoseTarget":
                heat = generate_pose_target(
                    kp, kpscore, img_shape, s.get("sigma", 0.6),
                    s.get("use_score", True), s.get("with_kp", True),
                    s.get("with_limb", False),
                    s.get("skeletons", COCO_SKELETONS),
                    s.get("double", False),
                    s.get("left_kp", COCO_LEFT_KP),
                    s.get("right_kp", COCO_RIGHT_KP))
            elif t in ("FormatShape", "Collect", "ToTensor", "Normalize"):
                pass  # layout fixed below; normalization is on-device
            else:
                raise KeyError(f"unsupported pose pipeline step {t}")

        if heat is None:
            raise ValueError("pipeline has no GeneratePoseTarget step")
        # ``double`` doubles the CLIP count (reference FormatShape divides
        # the frame total by clip_len), not the clip length
        n_clips_eff = heat.shape[0] // self.clip_len
        return heat.reshape(n_clips_eff, self.clip_len,
                            *heat.shape[1:]), label
