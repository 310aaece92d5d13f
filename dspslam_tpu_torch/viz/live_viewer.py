"""Live in-run viewer for headless machines.

Port of dspslam_tpu/viz/live_viewer.py (host code). The reference's Viewer
thread (src/Viewer.cc:59-176) drives a Pangolin window beside tracking: the
3D map view and the current-frame overlay. This is its headless
equivalent: a `tick()` from the main loop refreshes

  * `map.png`: the MapDrawer-style snapshot (points, frusta, covisibility
    graph, spanning tree, objects; matplotlib);
  * `frame.png`: the FrameDrawer overlay of the latest finished frame;
  * `index.html`: an auto-refreshing page showing both;

and an optional background HTTP server on 127.0.0.1 (`serve_port`) makes
the pair a live view in a browser. Rendering runs every `every` frames and
at most once per `budget_s` of wall time, so a slow refresh happens less
often instead of holding up tracking (the reference's viewer thread drops
frames the same way).
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta http-equiv="refresh" content="1">
<title>dspslam_tpu_torch live</title></head>
<body style="background:#111;color:#eee;font-family:monospace">
<div>{status}</div>
<img src="frame.png?t={t}" style="max-width:100%"><br>
<img src="map.png?t={t}" style="max-width:70%">
</body></html>"""


class LiveViewer:
    def __init__(self, system, out_dir: str, every: int = 5,
                 serve_port: int | None = None, budget_s: float = 0.5):
        self.system = system
        self.out_dir = out_dir
        self.every = max(1, int(every))
        self.budget_s = budget_s
        self._last_render = 0.0
        self._httpd = None
        os.makedirs(out_dir, exist_ok=True)
        if serve_port is not None:
            self._start_server(serve_port)

    def _start_server(self, port: int):
        import functools
        import http.server

        handler = functools.partial(
            http.server.SimpleHTTPRequestHandler, directory=self.out_dir
        )
        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), handler
        )
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()

    def tick(self, frame_id: int, frame=None, img=None):
        """Refresh the view. `frame`/`img`: the latest FINISHED frame and
        its grayscale image (pipelined mode finishes one frame late —
        pass what track_stereo returned)."""
        if frame_id % self.every != 0:
            return
        now = time.perf_counter()
        if now - self._last_render < self.budget_s:
            return        # render slower than the camera, never block it
        self._last_render = now
        from . import renderer

        renderer.save_map_snapshot(
            self.system.map, os.path.join(self.out_dir, "map.png")
        )
        if frame is not None and img is not None:
            from PIL import Image

            from . import frame_drawer

            overlay = frame_drawer.draw_frame(
                np.asarray(img), frame.feats, frame.map_point_ids,
                state=self.system.state.name,
            )
            Image.fromarray(overlay).save(
                os.path.join(self.out_dir, "frame.png")
            )
        status = (
            f"frame {frame_id} | state {self.system.state.name} | "
            f"KFs {len(self.system.map.keyframes)} | "
            f"points {len(self.system.map.points)} | "
            f"objects {len(self.system.map.objects)}"
        )
        with open(os.path.join(self.out_dir, "index.html"), "w") as f:
            f.write(_PAGE.format(status=status, t=frame_id))

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
