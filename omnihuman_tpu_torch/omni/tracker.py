"""Problematic-video event tracker of the data plane (host-only copy of
omnihuman_tpu/omni/tracker.py; the same events, files and summary).

Typed events (`VideoEvent`, the seven names kept verbatim: they are the
log format of datasets the reference produced), a singleton tracker that
appends each event to `events.jsonl`, keeps `invalid_videos.txt` (one
path a line, usable as a dataset exclusion list) and `failures.json`, and
writes `processing_summary.txt`; `reset()` drops the singleton. Offline:
`parse_event_log` and `cleanup_failed_videos`.
"""

from __future__ import annotations

import enum
import json
import os
import shutil
import time
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Set

from omnihuman_tpu_torch.utils.logging import logger


class VideoEvent(enum.Enum):
    VIDEO_TOO_SHORT = "video_too_short"
    NO_AUDIO = "no_audio"
    INVALID_FRAMES = "invalid_frames"
    FACE_DETECTION_FAILED = "face_detection_failed"
    LANDMARK_DETECTION_FAILED = "landmark_detection_failed"
    PROCESSING_ERROR = "processing_error"
    NO_VALID_WINDOWS = "no_valid_windows"


@dataclass
class VideoEventData:
    video_path: str
    event_type: VideoEvent
    details: Dict[str, Any] = field(default_factory=dict)
    timestamp: Optional[float] = None

    def __post_init__(self):
        if self.timestamp is None:
            self.timestamp = time.time()

    def as_record(self) -> Dict[str, Any]:
        return {
            "ts": datetime.fromtimestamp(self.timestamp).isoformat(
                timespec="seconds"),
            "event": self.event_type.value,
            "video": self.video_path,
            "details": self.details,
        }


class ProblematicVideoTracker:
    """Singleton event bus for data-pipeline failures."""

    _instance: Optional["ProblematicVideoTracker"] = None

    def __new__(cls, output_dir=None):
        if cls._instance is None:
            if output_dir is None:
                raise ValueError("output_dir required for first init")
            inst = super().__new__(cls)
            inst._init(Path(output_dir))
            cls._instance = inst
        return cls._instance

    def _init(self, output_dir: Path):
        self.output_dir = output_dir
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.invalid_videos_path = self.output_dir / "invalid_videos.txt"
        self.event_log_path = self.output_dir / "events.jsonl"
        self.failures_path = self.output_dir / "failures.json"
        self.summary_path = self.output_dir / "processing_summary.txt"
        self.problematic_videos: Set[str] = set()
        self.failed_videos: Dict[str, List[VideoEventData]] = {}
        self.event_counts: Dict[VideoEvent, int] = {e: 0 for e in VideoEvent}
        self._subscribers: List[Callable[[VideoEventData], None]] = []
        logger.info(f"ProblematicVideoTracker at {output_dir}")

    @classmethod
    def get_instance(cls) -> "ProblematicVideoTracker":
        if cls._instance is None:
            raise RuntimeError("ProblematicVideoTracker not initialized")
        return cls._instance

    @classmethod
    def reset(cls):
        cls._instance = None

    # -- event intake ---------------------------------------------------------

    def subscribe(self, fn: Callable[[VideoEventData], None]):
        """Attach an extra sink; called after the built-in recorder."""
        self._subscribers.append(fn)

    def track(self, video_path: str, event: VideoEvent,
              details: Optional[Dict] = None):
        self.dispatch(VideoEventData(str(video_path), event, details or {}))

    def dispatch(self, d: VideoEventData):
        self._record(d)
        for fn in self._subscribers:
            try:
                fn(d)
            except Exception as e:  # pragma: no cover
                logger.error(f"tracker subscriber failed: {e}")

    def _record(self, d: VideoEventData):
        self.event_counts[d.event_type] += 1
        self.failed_videos.setdefault(d.video_path, []).append(d)
        self.problematic_videos.add(d.video_path)
        with open(self.event_log_path, "a") as f:
            f.write(json.dumps(d.as_record()) + "\n")
        self._flush_failure_files()

    # -- persisted artifacts --------------------------------------------------

    def _flush_failure_files(self):
        # one path per line: directly usable as a dataset exclusion list
        self.invalid_videos_path.write_text(
            "".join(f"{p}\n" for p in sorted(self.problematic_videos)))
        detail = {
            path: [ev.as_record() for ev in
                   sorted(events, key=lambda e: e.timestamp)]
            for path, events in self.failed_videos.items()
        }
        self.failures_path.write_text(json.dumps(detail, indent=1))

    def save_summary(self):
        lines = [f"videos excluded: {len(self.problematic_videos)}",
                 f"events recorded: {sum(self.event_counts.values())}"]
        lines += [f"{e.value} = {c}"
                  for e, c in self.event_counts.items() if c]
        self.summary_path.write_text("".join(f"{ln}\n" for ln in lines))

    def get_problematic_videos(self) -> Set[str]:
        return self.problematic_videos


# ---------------------------------------------------------------------------
# offline utilities (reference video_tracker.py:187-313)


def parse_event_log(log_path: str) -> Dict[str, List[str]]:
    """JSONL event log → {video_path: [event names]}."""
    failures: Dict[str, List[str]] = {}
    if not os.path.exists(log_path):
        return failures
    with open(log_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                failures.setdefault(rec["video"], []).append(rec["event"])
            except (json.JSONDecodeError, KeyError):
                # tolerate the legacy tab-separated format (ts, event, path)
                parts = line.split("\t")
                if len(parts) >= 3:
                    failures.setdefault(parts[2], []).append(parts[1])
    return failures


def cleanup_failed_videos(log_path: str, action: str = "list",
                          quarantine_dir: Optional[str] = None
                          ) -> List[str]:
    """Offline cleanup: list / move / delete videos named in the log
    (reference's log-parsing + failed-video cleanup CLIs)."""
    failures = parse_event_log(log_path)
    handled = []
    for path in failures:
        if not os.path.exists(path):
            continue
        if action == "delete":
            os.remove(path)
        elif action == "move":
            assert quarantine_dir, "quarantine_dir required for move"
            os.makedirs(quarantine_dir, exist_ok=True)
            shutil.move(path, os.path.join(quarantine_dir,
                                           os.path.basename(path)))
        handled.append(path)
    return handled
