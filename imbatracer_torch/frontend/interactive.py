"""Interactive preview: first-person camera control + live terminal view
(torch twin of imbatracer_tpu.frontend.interactive).

Plays the role of the reference's SDL render window and camera controller
(reference: frontend/render_window.cpp:50-162 event/render loop,
frontend/main.cpp:19-85 CameraControl): WASD/QE move, IJKL look, camera
moves reset accumulation, the image redraws live.  The camera is an
argument of the frame function (engine.make_camera_frame_fn), so a move
changes no scene data and builds nothing.

The "window" is the terminal: the tone-mapped film is down-sampled and
drawn with 24-bit ANSI half-blocks (two pixels per character cell) on the
alternate screen buffer.  Works over ssh; no display server needed.

Keys:  w/a/s/d  move      q/e   down/up        i/j/k/l  look
       +/-      speed     r     reset accum    p        save PNG
       ESC/x    quit (saves the final image)
"""

from __future__ import annotations

import os
import re
import select
import shutil
import sys
import time

import numpy as np
import torch

from ..render.camera import Camera, make_camera
from ..utils.log import logger


class FirstPersonCamera:
    """Position + orientation state with the reference's control scheme
    (main.cpp FirstPersonCamera: move along forward/right, yaw about the
    world up, pitch about the local right)."""

    def __init__(self, pos, direction, up, speed: float, rot_speed=0.06):
        self.pos = np.asarray(pos, np.float64).copy()
        f = np.asarray(direction, np.float64)
        self.forward = f / np.linalg.norm(f)
        u = np.asarray(up, np.float64)
        self.up = u / np.linalg.norm(u)
        self.speed = float(speed)
        self.rot_speed = float(rot_speed)

    @property
    def right(self):
        r = np.cross(self.forward, self.up)
        return r / np.linalg.norm(r)

    def move(self, dx: float, dy: float, dz: float):
        """dx: right, dy: up, dz: forward (units of speed)."""
        self.pos += self.speed * (
            dx * self.right + dy * self.up + dz * self.forward
        )

    def _rotate(self, axis, angle):
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(angle), np.sin(angle)
        f = self.forward
        self.forward = (
            f * c + np.cross(axis, f) * s + axis * np.dot(axis, f) * (1 - c)
        )
        self.forward /= np.linalg.norm(self.forward)

    def yaw(self, angle):
        self._rotate(self.up, angle)

    def pitch(self, angle):
        # Clamp so forward never reaches the up axis (gimbal guard).
        new = FirstPersonCamera(self.pos, self.forward, self.up, 1.0)
        new._rotate(self.right, angle)
        if abs(np.dot(new.forward, self.up)) < 0.99:
            self.forward = new.forward

    def camera(self, width: int, height: int, fov: float,
               device="cpu") -> Camera:
        """The renderer's Camera on `device` (the scene's)."""
        return make_camera(self.pos, self.forward, self.up, width, height,
                           fov, device=device)


def ansi_preview(img: np.ndarray, cols: int, rows: int) -> str:
    """Tone-mapped (H, W, 3) [0,1] image -> 24-bit half-block string.

    Each character cell shows two vertically stacked pixels
    (fg = upper ▀, bg = lower), so `rows` text rows display 2*rows pixel
    rows.  Mean-pooled to the target grid; pure NumPy."""
    h, w, _ = img.shape
    ph, pw = rows * 2, cols
    ys = (np.arange(ph + 1) * h) // ph
    xs = (np.arange(pw + 1) * w) // pw
    # integral image for fast box means
    ii = np.zeros((h + 1, w + 1, 3), np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(img, axis=0), axis=1)
    a = ii[ys[:-1][:, None], xs[:-1][None, :]]
    b = ii[ys[1:][:, None], xs[1:][None, :]]
    c = ii[ys[:-1][:, None], xs[1:][None, :]]
    d = ii[ys[1:][:, None], xs[:-1][None, :]]
    areas = ((ys[1:] - ys[:-1])[:, None] * (xs[1:] - xs[:-1])[None, :])
    px = (a + b - c - d) / np.maximum(areas, 1)[:, :, None]
    rgb = np.clip(px * 255.0, 0, 255).astype(np.uint8)
    top = rgb[0::2]
    bot = rgb[1::2]
    lines = []
    for y in range(rows):
        parts = []
        for x in range(cols):
            tr, tg, tb = top[y, x]
            br, bg_, bb = bot[y, x]
            parts.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
            )
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


_CSI_RE = re.compile(
    r"\x1b\[A|\x1b\[B|\x1b\[C|\x1b\[D"      # arrows (mapped below)
    r"|\x1b\[[0-9;<=>?]*[a-zA-Z~]"          # other CSI (F-keys, mouse, ...)
    r"|\x1bO."                               # SS3 (F1-F4, keypad)
)


def _map_escape(m: "re.Match[str]") -> str:
    return {"\x1b[A": "i", "\x1b[B": "k",
            "\x1b[D": "j", "\x1b[C": "l"}.get(m.group(0), "")


def _read_keys(timeout: float) -> str:
    """Drain pending stdin bytes (raw mode), arrow keys mapped to ijkl.

    Unrecognised CSI/SS3 escape sequences (F-keys, Home/End, mouse
    reports) are STRIPPED, not passed through: a leftover raw \\x1b would
    read as ESC and quit the preview.  Only a bare ESC (no following
    bytes in the same drain) reaches the key loop."""
    keys = ""
    while True:
        r, _, _ = select.select([sys.stdin], [], [], timeout)
        if not r:
            return keys
        ch = os.read(sys.stdin.fileno(), 64).decode(errors="ignore")
        ch = _CSI_RE.sub(_map_escape, ch)
        # Any ESC still followed by bytes is an unfinished/unknown
        # sequence — drop through the end of the chunk.
        idx = ch.find("\x1b")
        if idx >= 0 and idx != len(ch) - 1:
            ch = ch[:idx]
        keys += ch
        timeout = 0.0


# Key -> FirstPersonCamera move (dx right, dy up, dz forward).
_MOVES = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0), "d": (1, 0, 0),
          "q": (0, -1, 0), "e": (0, 1, 0)}


def run_interactive(scene, meta, settings, out_path: str):
    """The interactive render loop (render_window.cpp:50-122 analogue)."""
    import termios
    import tty

    from .engine import make_camera_frame_fn
    from .renderer import ProgressiveRenderer

    if not sys.stdin.isatty():
        raise SystemExit("--interactive needs a TTY (run without -q "
                         "redirection); use the normal mode otherwise")

    device = scene.device
    core, cam0 = make_camera_frame_fn(scene, meta, settings)
    # Camera speed from the scene extent, like the reference derives it
    # from the setup (main.cpp:142-147 velocity argument).
    speed = float(scene.bsphere.radius) * 0.05
    fps_cam = FirstPersonCamera(meta.cam_pos, meta.cam_dir, meta.cam_up,
                                speed)
    state = {"cam": cam0}
    r = ProgressiveRenderer(lambda f: core(f, state["cam"]), settings,
                            device)

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    sys.stdout.write("\x1b[?1049h\x1b[?25l")  # alt screen, hide cursor
    try:
        tty.setcbreak(fd)
        frame_times = []
        while True:
            t1 = time.time()
            r.step()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            frame_times.append(time.time() - t1)

            size = shutil.get_terminal_size((80, 24))
            cols = min(size.columns, 120)
            rows = max(min(size.lines - 2, 60), 4)
            img = r.image()
            sys.stdout.write("\x1b[H")
            sys.stdout.write(ansi_preview(img, cols, rows))
            fps = 1.0 / max(np.mean(frame_times[-10:]), 1e-9)
            sys.stdout.write(
                f"\n\x1b[0m\x1b[K{r.frames * settings.spp} spp  "
                f"{fps:5.2f} fps  speed {fps_cam.speed:.3g}  "
                f"pos {np.round(fps_cam.pos, 2)}  "
                f"[wasdqe move, ijkl look, +/- speed, r reset, p save, "
                f"x quit]"
            )
            sys.stdout.flush()

            moved = False
            for ch in _read_keys(0.0):
                if ch in ("x", "\x1b", "\x03"):
                    raise KeyboardInterrupt
                if ch in _MOVES:
                    fps_cam.move(*_MOVES[ch])
                    moved = True
                elif ch in ("i", "k"):
                    fps_cam.pitch(fps_cam.rot_speed * (1 if ch == "i"
                                                       else -1))
                    moved = True
                elif ch in ("j", "l"):
                    fps_cam.yaw(fps_cam.rot_speed * (1 if ch == "j"
                                                     else -1))
                    moved = True
                elif ch == "+":
                    fps_cam.speed *= 1.5
                elif ch == "-":
                    fps_cam.speed /= 1.5
                elif ch == "r":
                    r.reset()
                elif ch == "p":
                    r.save(out_path)
            if moved:
                # Camera moved: a new Camera, restart accumulation
                # (render_window.cpp:164-175 clear-on-input).
                state["cam"] = fps_cam.camera(
                    settings.width, settings.height, settings.fov, device)
                r.reset()
    except KeyboardInterrupt:
        pass
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[?25h\x1b[?1049l")
        sys.stdout.flush()
    r.save(out_path)
    logger.info("interactive preview ended after %d frames", r.frames)
