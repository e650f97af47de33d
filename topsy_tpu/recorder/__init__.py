"""Camera/parameter recording and movie export.

The recorder joins the visualizer's ``ViewSynchronizer`` as a fake second
view: every synchronized property change lands in ``_capture_event`` and is
appended, timestamped, to the property's timestream.  Replay samples the
streams on a fixed frame clock (``recorder.interpolator``) and pushes the
values back into the visualizer, yielding EXPORT frames that ``save_mp4``
encodes via OpenCV.

Timestreams pickle as a plain ``({property_path: [(t, value), ...]},
end_time)`` tuple — the same data layout the reference writes (reference:
src/topsy/recorder/__init__.py), so recordings are interchangeable.
"""

from __future__ import annotations

import copy
import logging
import pickle
import time
from typing import NamedTuple

import numpy as np

from ..drawreason import DrawReason
from ..view_synchronizer import (ViewSynchronizer, _resolve_path_get,
                                 _resolve_path_set)
from . import interpolator as interp

logger = logging.getLogger(__name__)


class _Tracked(NamedTuple):
    """One recorded property: its access path and its replay samplers."""
    path: str
    smoothed: type
    plain: type


# Order is functional, not cosmetic: colormap type and quantity must replay
# before vmin/vmax so a mode switch's autoscaling cannot clobber recorded
# limits (reference: src/topsy/recorder/__init__.py:27).  Discrete values
# step; scalar limits ramp; the rotation matrix stays orthogonal.
_TRACKED = [
    _Tracked("colormap[type]", interp.StepInterpolator,
             interp.StepInterpolator),
    _Tracked("quantity_name", interp.StepInterpolator,
             interp.StepInterpolator),
    _Tracked("colormap[log]", interp.StepInterpolator,
             interp.StepInterpolator),
    _Tracked("colormap[vmin]", interp.SmoothedStepInterpolator,
             interp.StepInterpolator),
    _Tracked("colormap[vmax]", interp.SmoothedStepInterpolator,
             interp.StepInterpolator),
    _Tracked("colormap[gamma]", interp.SmoothedStepInterpolator,
             interp.StepInterpolator),
    _Tracked("colormap[density_vmin]", interp.SmoothedStepInterpolator,
             interp.StepInterpolator),
    _Tracked("colormap[density_vmax]", interp.SmoothedStepInterpolator,
             interp.StepInterpolator),
    _Tracked("rotation_matrix", interp.SmoothedRotationInterpolator,
             interp.RotationInterpolator),
    _Tracked("scale", interp.SmoothedLinearInterpolator,
             interp.LinearInterpolator),
    _Tracked("position_offset", interp.SmoothedLinearInterpolator,
             interp.LinearInterpolator),
]


def _frame_to_rgb8(frame):
    """EXPORT frames are float RGBA in [0, 1]; encoders want uint8 RGB."""
    if frame.dtype != np.uint8:
        frame = (np.clip(frame.astype(np.float32), 0.0, 1.0)
                 * 255 + 0.5).astype(np.uint8)
    return frame[:, :, :3]


class VisualizationRecorder:
    """Records synchronized visualizer properties; replays them to frames."""

    _record_properties = [t.path for t in _TRACKED]

    def __init__(self, visualizer):
        sync = ViewSynchronizer(synchronize=self._record_properties)
        sync.add_view(visualizer)
        sync.add_view(self, setter=VisualizationRecorder._capture_event)
        self._visualizer = visualizer
        self._recording = False
        self._playback = False
        self._t0 = None
        self._end_time = None
        self._streams = self._initial_streams()

    # -- capture ------------------------------------------------------------

    def _initial_streams(self):
        """Every stream opens at t=0 with the property's current value, so
        replay restores state even for properties never touched while
        recording."""
        return {t.path: [(0.0, copy.copy(_resolve_path_get(self._visualizer,
                                                           t.path)))]
                for t in _TRACKED}

    def _capture_event(self, key, value):
        # called by the synchronizer in place of a real view's setter
        if key not in self._streams:
            return
        self._view_synchronizer.update_completed(self)
        if self._recording:
            self._streams[key].append((time.time() - self._t0,
                                       copy.copy(value)))

    def record(self):
        self._t0 = time.time()
        self._streams = self._initial_streams()
        self._recording = True
        self._playback = False

    def stop(self):
        if self._recording:
            self._end_time = time.time() - self._t0
        self._recording = False
        self._playback = False

    @property
    def recording(self):
        return self._recording

    # -- replay -------------------------------------------------------------

    def _samplers(self, smooth, exclude):
        return {t.path: (t.smoothed if smooth else t.plain)(
                    self._streams[t.path])
                for t in _TRACKED if t.path not in exclude}

    def _progress_iterator(self, ntot):
        import tqdm
        return tqdm.tqdm(range(ntot), unit="frame")

    def _replay(self, fps=30.0, resolution=(1920, 1080), show_colorbar=True,
                show_scalebar=True, smooth=True, set_vmin_vmax=True,
                set_quantity=True):
        """Yield uint8 RGB frames of the recorded session at ``fps``."""
        if self._recording:
            self.stop()
        if self._end_time is None:
            raise RuntimeError("Can't playback before recording")
        self._playback = True

        # NB the reference matches bare 'vmin'/'vmax' against the full
        # 'colormap[...]' paths, which never excludes anything; this honours
        # the documented intent of set_vmin_vmax instead
        exclude = set()
        if not set_vmin_vmax:
            exclude |= {"colormap[vmin]", "colormap[vmax]",
                        "colormap[density_vmin]", "colormap[density_vmax]"}
        if not set_quantity:
            exclude.add("quantity_name")

        vis = self._visualizer
        try:
            vis.show_colorbar = show_colorbar
            vis.show_scalebar = show_scalebar
            samplers = self._samplers(smooth, exclude)

            for i in self._progress_iterator(int(self._end_time * fps)):
                t = i / fps
                for tracked in _TRACKED:
                    sampler = samplers.get(tracked.path)
                    if sampler is None:
                        continue
                    value = sampler(t)
                    if value is not interp.Interpolator.no_value:
                        _resolve_path_set(vis, tracked.path, value)

                vis.display_status("topsy_tpu", timeout=1e6)
                yield _frame_to_rgb8(vis.draw(DrawReason.EXPORT,
                                              target=resolution))
            self._playback = False
        finally:
            vis.show_colorbar = True
            vis.show_scalebar = True
            vis.display_status("Complete", timeout=1.0)

    def save_mp4(self, filename, fps=30.0, resolution=(1920, 1080),
                 *args, **kwargs):
        from ..util import require
        cv2 = require("cv2", "mp4 export")
        writer = cv2.VideoWriter(filename, cv2.VideoWriter.fourcc(*"mp4v"),
                                 fps, resolution)
        for image in self._replay(fps, resolution, *args, **kwargs):
            writer.write(image[:, :, ::-1])  # RGB -> BGR for OpenCV
        writer.release()
        logger.info("Saved %s", filename)

    # -- persistence (reference-compatible pickle layout) -------------------

    def save_timestream(self, fname):
        with open(fname, "wb") as f:
            pickle.dump((self._streams, self._end_time), f)

    def load_timestream(self, fname):
        with open(fname, "rb") as f:
            self._streams, self._end_time = pickle.load(f)
