"""Shared video-trimming helper of the port's data-prep tools (mirrors
``tools/data/_trim.py``).

Trimming decodes through the port's readers (``data/video_reader.py``: the
C++ FFmpeg library when built, OpenCV otherwise) and re-encodes with
``cv2.VideoWriter`` (mp4v), as the JAX helper does: no ffmpeg binary is
needed.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def video_duration(path: str) -> float:
    """Duration in seconds: frames over the average frame rate."""
    from adapt_image_models_torch.data.video_reader import open_video
    r = open_video(path)
    try:
        return r.num_frames / max(r.avg_fps, 1e-6)
    finally:
        r.close()


def trim_video(src: str, dst: str, start_s: float, dur_s: float,
               fps: float = None, chunk: int = 32) -> bool:
    """Extract ``[start_s, start_s + dur_s)`` of ``src`` into ``dst``.

    Frames stream through in ``chunk``-sized batches, so memory stays
    bounded whatever the clip's length and resolution. The clip is written
    under a temporary name and renamed on success: a decode failure midway
    leaves no truncated file that a re-run would take for a finished clip."""
    import cv2
    from adapt_image_models_torch.data.video_reader import open_video
    r = open_video(src)
    writer = None
    tmp_dst = dst + ".part.mp4"
    ok = False
    try:
        in_fps = r.avg_fps or 30.0
        out_fps = fps or in_fps
        first = max(0, int(round(start_s * in_fps)))
        last = min(r.num_frames, int(round((start_s + dur_s) * in_fps)))
        if last <= first:
            return False
        for s in range(first, last, chunk):
            frames = r.get_frames(list(range(s, min(s + chunk, last))))
            if writer is None:
                h, w = frames.shape[1:3]
                writer = cv2.VideoWriter(tmp_dst, cv2.VideoWriter_fourcc(*"mp4v"),
                                         out_fps, (w, h))
                if not writer.isOpened():
                    return False
            for f in frames:
                writer.write(f[:, :, ::-1])  # RGB -> BGR
        ok = writer is not None
    finally:
        r.close()
        if writer is not None:
            writer.release()
        if ok:
            os.replace(tmp_dst, dst)
        elif os.path.exists(tmp_dst):
            os.remove(tmp_dst)
    return ok
