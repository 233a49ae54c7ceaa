"""Interactive terminal viewer.

Port of ``gpu_bidirectional_raytracer_tpu/render/viewer.py``: progressive
passes render continuously and display in the terminal as 24-bit-color
half-block characters (two pixels per character cell), while the
reference's key bindings drive the camera and scene edits:

    w/a/s/d  move camera      r/f     camera up/down
    arrows   rotate camera    PgUp/Dn move target up/down
    + / -    select sphere    2/4/6/8/9/3  move selected sphere
    p        save PPM         space   re-init accumulation
    h        help             q / ESC quit

Pure ANSI + termios; no GL, no curses dependency.
"""

from __future__ import annotations

import select
import sys
import termios
import time
import tty

import numpy as np

import torch

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm

ESC = "\x1b"

HELP = """\
 h: help  q/ESC: quit  space: restart accumulation  p: save PPM
 w/a/s/d: move camera  r/f: up/down  arrows: rotate  PgUp/PgDn: target
 +/-: select sphere    numpad 2/4/6/8/9/3: move selected sphere"""


def _frame_to_ansi(img: np.ndarray) -> str:
    """Bottom-up float image -> half-block ANSI art (2 rows per line)."""
    b = vm.gamma_to_byte(torch.as_tensor(img)).cpu().numpy()[::-1]
    h, w, _ = b.shape
    if h % 2:
        b = b[:-1]
        h -= 1
    out = []
    for y in range(0, h, 2):
        row = []
        for x in range(w):
            tr, tg, tb = b[y, x]
            br, bg, bb = b[y + 1, x]
            row.append(f"{ESC}[38;2;{tr};{tg};{tb}m"
                       f"{ESC}[48;2;{br};{bg};{bb}m▀")
        out.append("".join(row) + f"{ESC}[0m")
    return "\n".join(out)


class _RawKeys:
    """Non-blocking raw keyboard reads with arrow/PgUp/PgDn decoding."""

    def __enter__(self):
        self.fd = sys.stdin.fileno()
        self.old = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.old)

    def poll(self) -> str | None:
        if not select.select([sys.stdin], [], [], 0)[0]:
            return None
        ch = sys.stdin.read(1)
        if ch != ESC:
            return ch
        if not select.select([sys.stdin], [], [], 0.01)[0]:
            return "ESC"
        seq = sys.stdin.read(1)
        if seq != "[":
            return "ESC"
        code = sys.stdin.read(1)
        arrows = {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}
        if code in arrows:
            return arrows[code]
        if code in ("5", "6"):
            sys.stdin.read(1)  # trailing '~'
            return "PGUP" if code == "5" else "PGDN"
        return None


MOVE_STEP = 10.0
ROTATE_STEP = 2.0 * np.pi / 180.0
SPHERE_STEP = 5.0              # 0.5 * MOVE_STEP


# Target wall-time between key polls: keeps input latency ~100 ms while
# the adaptive chunk below packs as many passes as fit into it.
_POLL_TARGET_S = 0.1
_MAX_CHUNK = 64


def run_viewer(renderer) -> None:
    """Drive a `Renderer` interactively until q/ESC.

    The passes between key polls run through `Renderer.step_n`, with the
    chunk adapted so that each poll interval stays about 100 ms: stepping
    one pass a poll would spend the interval on the host's per-pass work
    and the frame's copy back instead of on passes.
    """
    from gpu_bidirectional_raytracer_tpu_torch.render import film

    if not sys.stdin.isatty():
        raise RuntimeError("viewer needs a tty; use the render command "
                           "for headless output")
    r = renderer
    current = 0
    show_help = True
    t0 = time.time()
    chunk = 1  # the first iteration times one pass (kernel build included)
    sys.stdout.write(f"{ESC}[2J")  # clear
    with _RawKeys() as keys:
        while True:
            ts = time.time()
            r.step_n(chunk)
            img = r.state.colors.cpu().numpy()  # waits for the card
            step_s = max(time.time() - ts, 1e-6)
            # Adapt: pack ~_POLL_TARGET_S of passes per poll. The first
            # iteration (kernel build included) underestimates
            # throughput; the estimate converges within two polls.
            per_pass = step_s / chunk
            chunk = max(1, min(_MAX_CHUNK,
                               int(_POLL_TARGET_S / per_pass)))
            sys.stdout.write(f"{ESC}[H")
            sys.stdout.write(_frame_to_ansi(img))
            n = int(r.state.sample)
            el = time.time() - t0
            sps = r.width * r.height * n / max(el, 1e-9)
            sys.stdout.write(
                f"\n{ESC}[0mpass {n} (x{chunk}/poll)  {el:6.1f}s  "
                f"{sps / 1e3:8.1f}K samples/s  sphere #{current}   ")
            if show_help:
                sys.stdout.write("\n" + HELP)
            sys.stdout.flush()

            k = keys.poll()
            if k is None:
                continue
            if k in ("q", "ESC"):
                print()
                return
            elif k == "h":
                show_help = not show_help
                sys.stdout.write(f"{ESC}[2J")
            elif k == " ":
                r.reset()
                t0 = time.time()
            elif k == "p":
                name = film.snapshot_name(r.cfg.max_vlp, el, n)
                film.write_ppm(img, name)
            elif k in ("w", "s"):
                r.move_camera("dir", MOVE_STEP if k == "w" else -MOVE_STEP)
                t0 = time.time()
            elif k in ("a", "d"):
                r.move_camera("x", MOVE_STEP if k == "d" else -MOVE_STEP)
                t0 = time.time()
            elif k in ("r", "f"):
                r.move_camera("y_world", MOVE_STEP if k == "r" else -MOVE_STEP)
                t0 = time.time()
            elif k in ("UP", "DOWN"):
                r.rotate_camera("pitch",
                                -ROTATE_STEP if k == "UP" else ROTATE_STEP)
                t0 = time.time()
            elif k in ("LEFT", "RIGHT"):
                r.rotate_camera("yaw",
                                -ROTATE_STEP if k == "LEFT" else ROTATE_STEP)
                t0 = time.time()
            elif k in ("PGUP", "PGDN"):
                dy = MOVE_STEP if k == "PGUP" else -MOVE_STEP
                from gpu_bidirectional_raytracer_tpu_torch.core.types import (
                    Camera,
                )

                target = r.camera.target.clone()
                target[1] += dy
                r.camera = Camera.update(r.camera.orig, target, r.width,
                                         r.height, r.cfg.fov_deg)
                r.reset()
                t0 = time.time()
            elif k == "+":
                current = (current + 1) % r.scene.num_spheres
            elif k == "-":
                current = (current - 1) % r.scene.num_spheres
            elif k in "246893":
                delta = {
                    "4": [-SPHERE_STEP, 0, 0], "6": [SPHERE_STEP, 0, 0],
                    "8": [0, 0, -SPHERE_STEP], "2": [0, 0, SPHERE_STEP],
                    "9": [0, SPHERE_STEP, 0], "3": [0, -SPHERE_STEP, 0],
                }[k]
                r.edit_sphere(current, delta)
                t0 = time.time()
