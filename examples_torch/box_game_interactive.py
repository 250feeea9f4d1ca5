#!/usr/bin/env python
"""box_game with a REAL keyboard on the PyTorch port.

The reference's input system reads a live keyboard each frame (W/A/S/D to
a ``BoxInput`` bitmask); every other example here drives scripted
bitmasks. This demo goes through the same ``InputSystem`` seam the
scripted examples use (``app.py``'s ``with_input_system``): a raw-mode TTY
reader turns held keys into the u8 bitmask once per simulated frame, a
SyncTest session (player 1 is a scripted bot) does real rollbacks
underneath on the chosen device, and an ASCII arena renders as a
non-rollback render system, outside the rollback domain.

    python examples_torch/box_game_interactive.py            # play with W/A/S/D
    python examples_torch/box_game_interactive.py --frames 300 < /dev/null
    # non-TTY stdin: the input falls back to the script (the device does not)

Keys: W/A/S/D or arrow-key steering for player 0; Q or Ctrl-C quits.
A key press "holds" for HOLD_FRAMES sim frames (terminals deliver
autorepeat, not keyup events — the hold window bridges the repeat gap).
"""

import argparse
import os
import select
import sys

from box_game_common import (
    add_common_args,
    build_app,
    print_world,
    scripted_input,
    select_device,
)

HOLD_FRAMES = 6  # sim frames a pressed key stays "held"


class TtyKeys:
    """Non-blocking raw-mode key reader; context-manages termios state."""

    # Arrow-key escape tails (after ESC [) mapped to WASD equivalents.
    _ARROWS = {"A": "w", "B": "s", "C": "d", "D": "a"}

    def __init__(self):
        self.is_tty = sys.stdin.isatty()
        self._fd = sys.stdin.fileno() if self.is_tty else None
        self._saved = None
        self.quit = False
        self._held = {}  # key -> frames remaining

    def __enter__(self):
        if self.is_tty:
            import termios
            import tty

            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        if self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
        return False

    def _drain(self) -> str:
        chars = ""
        while select.select([sys.stdin], [], [], 0)[0]:
            got = os.read(self._fd, 64).decode(errors="ignore")
            if not got:
                break
            chars += got
        return chars

    def poll(self) -> None:
        """Consume pending keystrokes; refresh hold windows."""
        if not self.is_tty:
            return
        chars = self._drain()
        i = 0
        while i < len(chars):
            c = chars[i]
            if c == "\x1b" and chars[i + 1 : i + 2] == "[":
                c = self._ARROWS.get(chars[i + 2 : i + 3], "")
                i += 3
            else:
                i += 1
            c = c.lower()
            if c in ("q", "\x03"):
                self.quit = True
            elif c in "wasd":
                self._held[c] = HOLD_FRAMES

    def bits(self):
        """One frame's bitmask from the held keys; ages the hold windows."""
        import numpy as np

        from bevy_ggrs_tpu_torch.models import box_game

        mask = 0
        for key, bit in (
            ("w", box_game.INPUT_UP),
            ("s", box_game.INPUT_DOWN),
            ("a", box_game.INPUT_LEFT),
            ("d", box_game.INPUT_RIGHT),
        ):
            if self._held.get(key, 0) > 0:
                mask |= bit
                self._held[key] -= 1
        return np.uint8(mask)


def render_system_factory(arena: float = 4.0, cols: int = 41, rows: int = 13):
    """ASCII top-down arena view, redrawn in place each render frame: the
    non-rollback render-system slot (the reference's meshes and camera
    live outside the rollback domain)."""

    def render(app) -> None:
        world = app.world()
        alive = world["alive"]
        pos = world["components"]["translation"]
        handles = world["components"]["player_handle"]
        grid = [[" "] * cols for _ in range(rows)]
        for slot in range(len(alive)):
            if not alive[slot] or handles[slot] < 0:
                continue
            x, z = float(pos[slot][0]), float(pos[slot][2])
            c = int((x + arena) / (2 * arena) * (cols - 1) + 0.5)
            r = int((z + arena) / (2 * arena) * (rows - 1) + 0.5)
            c, r = max(0, min(cols - 1, c)), max(0, min(rows - 1, r))
            grid[r][c] = str(int(handles[slot]) % 10)
        frame = app.frame
        sys.stdout.write("\x1b[H\x1b[2J" if sys.stdout.isatty() else "")
        print(f"frame {frame}  (W/A/S/D move, Q quits)")
        print("+" + "-" * cols + "+")
        for row in grid:
            print("|" + "".join(row) + "|")
        print("+" + "-" * cols + "+")

    return render


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--num-players", type=int, default=2)
    add_common_args(parser)
    args = parser.parse_args(argv)
    device = select_device(args.device)

    from bevy_ggrs_tpu_torch.app import SessionType
    from bevy_ggrs_tpu_torch.models import box_game
    from bevy_ggrs_tpu_torch.session import SessionBuilder

    session = (
        SessionBuilder(box_game.INPUT_SPEC)
        .with_num_players(args.num_players)
        .with_check_distance(2)
        .with_max_prediction_window(8)
        .start_synctest_session()
    )

    with TtyKeys() as keys:

        def input_system(handle, app):
            if handle == 0 and keys.is_tty:
                return keys.bits()
            return scripted_input(handle, app)  # bots / non-TTY fallback

        app = build_app(args.num_players, 8, args.fps, input_system, device)
        app.insert_session(session, SessionType.SYNC_TEST)
        if keys.is_tty:
            app.add_render_system(render_system_factory())

        if keys.is_tty:
            import time

            period = 1.0 / args.fps
            for _ in range(args.frames):
                keys.poll()
                if keys.quit:
                    break
                t0 = time.monotonic()
                app.update()
                time.sleep(max(0.0, period - (time.monotonic() - t0)))
        else:
            app.run_for(args.frames, dt=1.0 / args.fps)

    print_world(app, f"interactive session ended at frame {app.frame}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
