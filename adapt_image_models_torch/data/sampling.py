"""Frame-index sampling — exact semantics of the reference's SampleFrames
(``mmaction/datasets/pipelines/loading.py:79-277``), including:

* train: random per-segment offsets within the average interval, with the
  three fallback branches for short videos (`:132-163`)
* test: centered offsets (+ optional ``twice_sample`` adding unshifted
  offsets, `:164-188`)
* ``frame_uniform=True``: SlowFast-style ``get_seq_frames`` used by the
  SSv2 / Diving-48 recipes (`:205-223`)
* ``temporal_jitter`` per-frame offsets (`:244-247`)
* out-of-bound handling ``loop`` / ``repeat_last`` (`:249-258`)

All functions are pure numpy over an explicit ``np.random.Generator`` —
deterministic and seedable per (epoch, sample), unlike the reference's
global ``np.random`` state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def _train_clip_offsets(rng: np.random.Generator, num_frames: int,
                        clip_len: int, frame_interval: int,
                        num_clips: int) -> np.ndarray:
    ori_clip_len = clip_len * frame_interval
    avg_interval = (num_frames - ori_clip_len + 1) // num_clips
    if avg_interval > 0:
        base = np.arange(num_clips) * avg_interval
        return base + rng.integers(avg_interval, size=num_clips)
    if num_frames > max(num_clips, ori_clip_len):
        return np.sort(rng.integers(num_frames - ori_clip_len + 1,
                                    size=num_clips))
    if avg_interval == 0:
        ratio = (num_frames - ori_clip_len + 1.0) / num_clips
        return np.around(np.arange(num_clips) * ratio).astype(np.int64)
    return np.zeros((num_clips,), dtype=np.int64)


def _test_clip_offsets(num_frames: int, clip_len: int, frame_interval: int,
                       num_clips: int, twice_sample: bool) -> np.ndarray:
    ori_clip_len = clip_len * frame_interval
    avg_interval = (num_frames - ori_clip_len + 1) / float(num_clips)
    if num_frames > ori_clip_len - 1:
        base = np.arange(num_clips) * avg_interval
        offsets = (base + avg_interval / 2.0).astype(np.int64)
        if twice_sample:
            offsets = np.concatenate([offsets, base.astype(np.int64)])
        return offsets
    n = num_clips * 2 if twice_sample else num_clips
    return np.zeros((n,), dtype=np.int64)


def _uniform_seq_frames(rng: Optional[np.random.Generator], num_frames: int,
                        clip_len: int, test_mode: bool) -> np.ndarray:
    """SlowFast SSv2-style whole-video uniform sampling (`:205-223`)."""
    seg_size = float(num_frames - 1) / clip_len
    seq = []
    for i in range(clip_len):
        start = int(np.round(seg_size * i))
        end = int(np.round(seg_size * (i + 1)))
        if test_mode:
            seq.append((start + end) // 2)
        else:
            seq.append(int(rng.integers(start, end + 1)))
    return np.asarray(seq, dtype=np.int64)


def sample_frames(num_frames: int, clip_len: int, frame_interval: int = 1,
                  num_clips: int = 1, *, test_mode: bool = False,
                  temporal_jitter: bool = False, twice_sample: bool = False,
                  frame_uniform: bool = False,
                  out_of_bound_opt: str = "loop", start_index: int = 0,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Return frame indices, shape (actual_num_clips * clip_len,)."""
    if out_of_bound_opt not in ("loop", "repeat_last"):
        raise ValueError(f"illegal out_of_bound_opt {out_of_bound_opt}")
    if rng is None:
        rng = np.random.default_rng()

    if frame_uniform:
        if start_index != 0:
            raise ValueError("frame_uniform requires start_index == 0")
        return _uniform_seq_frames(rng, num_frames, clip_len, test_mode)

    if test_mode:
        offsets = _test_clip_offsets(num_frames, clip_len, frame_interval,
                                     num_clips, twice_sample)
    else:
        offsets = _train_clip_offsets(rng, num_frames, clip_len,
                                      frame_interval, num_clips)

    inds = offsets[:, None] + np.arange(clip_len)[None, :] * frame_interval
    inds = np.concatenate(inds)
    if temporal_jitter:
        inds = inds + rng.integers(frame_interval, size=len(inds))
    inds = inds.reshape(-1, clip_len)
    if out_of_bound_opt == "loop":
        inds = np.mod(inds, num_frames)
    else:  # repeat_last
        safe = inds < num_frames
        last = np.max(np.where(safe, inds, 0), axis=1)
        inds = np.where(safe, inds, last[:, None])
    return np.concatenate(inds) + start_index


@dataclass
class SampleFrames:
    """Config-object wrapper mirroring the reference transform's signature."""

    clip_len: int
    frame_interval: int = 1
    num_clips: int = 1
    temporal_jitter: bool = False
    twice_sample: bool = False
    out_of_bound_opt: str = "loop"
    test_mode: bool = False
    frame_uniform: bool = False

    @property
    def views(self) -> int:
        """Number of temporal views produced (clips; x2 with twice_sample)."""
        if self.frame_uniform:
            return 1
        return self.num_clips * (2 if (self.twice_sample and self.test_mode) else 1)

    def __call__(self, num_frames: int, start_index: int = 0,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return sample_frames(
            num_frames, self.clip_len, self.frame_interval, self.num_clips,
            test_mode=self.test_mode, temporal_jitter=self.temporal_jitter,
            twice_sample=self.twice_sample, frame_uniform=self.frame_uniform,
            out_of_bound_opt=self.out_of_bound_opt, start_index=start_index,
            rng=rng)


@dataclass
class DenseSampleFrames:
    """Dense sampling within a 64-frame window (reference ``loading.py:341``)."""

    clip_len: int
    frame_interval: int = 1
    num_clips: int = 1
    sample_range: int = 64
    num_sample_positions: int = 10
    test_mode: bool = False

    @property
    def views(self) -> int:
        mult = self.num_sample_positions if self.test_mode else 1
        return self.num_clips * mult

    def __call__(self, num_frames: int, start_index: int = 0,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if rng is None:
            rng = np.random.default_rng()
        sample_position = max(1, 1 + num_frames - self.sample_range)
        interval = self.sample_range // self.num_clips
        if self.test_mode:
            start_list = np.linspace(0, sample_position - 1,
                                     num=self.num_sample_positions, dtype=int)
            base = np.arange(self.num_clips) * interval
            offsets = np.concatenate([base + s for s in start_list])
        else:
            start = rng.integers(sample_position)
            offsets = np.arange(self.num_clips) * interval + start
        inds = offsets[:, None] + np.arange(self.clip_len)[None, :] * self.frame_interval
        inds = np.mod(np.concatenate(inds), num_frames)
        return inds + start_index


@dataclass
class UntrimmedSampleFrames:
    """Evenly spaced clips over an untrimmed video (reference ``loading.py:282``)."""

    clip_len: int
    frame_interval: int = 16
    start_index: int = 0

    @property
    def views(self):
        """Video-length-dependent clip count — not static."""
        return None

    def __call__(self, num_frames: int, start_index: Optional[int] = None,
                 rng=None) -> np.ndarray:
        si = self.start_index if start_index is None else start_index
        clip_centers = np.arange(self.frame_interval // 2, num_frames,
                                 self.frame_interval)
        num_clips = len(clip_centers)
        inds = clip_centers[:, None] + np.arange(
            -(self.clip_len // 2), self.clip_len - (self.clip_len // 2))[None, :]
        inds = np.clip(inds, 0, num_frames - 1)
        return np.concatenate(inds) + si


@dataclass
class SampleProposalFrames:
    """Sample segment frames for SSN proposals (reference
    ``loading.py:486-700`` SampleProposalFrames).

    Per proposal, samples ``aug_segments[0]`` starting-stage,
    ``body_segments`` course-stage and ``aug_segments[1]`` ending-stage
    segment offsets (each a clip start index). In test mode, snippets tile
    the whole video every ``test_interval`` frames.
    """

    clip_len: int
    body_segments: int = 5
    aug_segments: tuple = (2, 2)
    aug_ratio: float = 0.5
    frame_interval: int = 1
    test_interval: int = 6
    mode: str = "train"

    def _aug_pair(self):
        a = self.aug_ratio
        return a if isinstance(a, (tuple, list)) else (a, a)

    @staticmethod
    def _train_offsets(valid_length: int, num_segments: int,
                       rng: np.random.Generator) -> np.ndarray:
        avg = (valid_length + 1) // num_segments
        if avg > 0:
            return (np.arange(num_segments) * avg
                    + rng.integers(avg, size=num_segments))
        return np.zeros(num_segments, np.int64)

    @staticmethod
    def _val_offsets(valid_length: int, num_segments: int) -> np.ndarray:
        if valid_length >= num_segments:
            avg = valid_length / float(num_segments)
            return (np.arange(num_segments) * avg + avg / 2.0).astype(np.int64)
        return np.zeros(num_segments, np.int64)

    def proposal_offsets(self, start_frame: int, end_frame: int,
                         num_frames: int,
                         rng: Optional[np.random.Generator] = None
                         ) -> np.ndarray:
        """One proposal -> (aug0 + body + aug1) segment start offsets."""
        rng = rng or np.random.default_rng()
        aug0, aug1 = self._aug_pair()
        ori_clip_len = self.clip_len * self.frame_interval
        duration = end_frame - start_frame
        assert duration > 0
        valid_length = duration - ori_clip_len
        valid_starting = max(0, start_frame - int(duration * aug0))
        valid_ending = min(num_frames - ori_clip_len + 1,
                           end_frame - 1 + int(duration * aug1))
        valid_starting_length = start_frame - valid_starting - ori_clip_len
        valid_ending_length = (valid_ending - end_frame + 1) - ori_clip_len

        fn = (lambda vl, n: self._train_offsets(vl, n, rng)) \
            if self.mode == "train" else self._val_offsets
        starting = fn(valid_starting_length, self.aug_segments[0]) \
            + valid_starting
        course = fn(valid_length, self.body_segments) + start_frame
        ending = fn(valid_ending_length, self.aug_segments[1]) + end_frame
        return np.concatenate([starting, course, ending])

    def __call__(self, num_frames: int, proposals=None, start_index: int = 0,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Train/val: frame indices for all proposals' segments, flattened
        (P * num_segments * clip_len,). Test: tiled snippet clip indices."""
        if self.mode == "test":
            ori_clip_len = self.clip_len * self.frame_interval
            offsets = np.arange(0, num_frames - ori_clip_len,
                                self.test_interval, dtype=np.int64)
        else:
            assert proposals is not None
            offsets = np.concatenate([
                self.proposal_offsets(p[0], p[1], num_frames, rng=rng)
                for p in proposals])
        inds = (offsets[:, None]
                + np.arange(self.clip_len)[None, :] * self.frame_interval)
        inds = np.clip(inds, 0, num_frames - 1)
        return np.concatenate(inds) + start_index
