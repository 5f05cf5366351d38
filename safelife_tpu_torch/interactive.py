"""The interactive terminal game: play and edit SafeLife levels.

Port of ``safelife_tpu/interactive.py:1-326`` (reference
``safelife/interactive_game.py``, the terminal front end): ``HELP``, the
key tables, ``getch``, ``GameLoop`` (play mode with undo, the per-level
side-effect summary, edit mode with the object palette and goal editing,
level iteration, recording) and ``play_cmd`` with
``_expand_benchmark_paths``. Rendering uses the ANSI renderer; input is
raw-mode ``getch``.

The game itself is host NumPy (:mod:`.game`); the end-of-level summary
scores side effects on ``device`` (``side_effect_score``, whose occupancy
runs kernel K2 a step on the card). ``GameLoop`` takes ``device="cuda"``
unless the CPU is asked for, and raises without a card.
"""

import os
import sys
import termios
import tty

import numpy as np

from .core import cells as C
from .game import SafeLifeGame
from .io.iterator import SafeLifeLevelIterator
from .loggers import combined_score
from .render.text import render_board
from .side_effects import side_effect_score, weighted_side_effect_total
from .utils.device import resolve_device

HELP = """
controls
  arrows / WASD   move (and face) the agent
  space / return  toggle the cell ahead (create or destroy life)
  c               stand still (advance one step)
  z               undo
  r               restart level
  n / p           next / previous level
  e               toggle edit mode
  ?               help           q  quit

edit mode
  arrows          move cursor    g  edit goals instead of board
  1-9,0,-,=       place: empty/life/hard-life/wall/crate/spawner/
                  hard-spawner/exit/icecube/tree/fountain/weed
  [ / ]           previous / next paint color
  x               apply color    s  save level
"""

EDIT_PALETTE = {
    "1": "EMPTY", "2": "LIFE", "3": "HARD LIFE", "4": "WALL",
    "5": "CRATE", "6": "SPAWNER", "7": "HARD SPAWNER", "8": "EXIT",
    "9": "ICECUBE", "0": "TREE", "-": "FOUNTAIN", "=": "WEED",
    "a": "AGENT", "t": "PLANT", "!": "PARASITE",
}

MOVE_KEYS = {
    "UP": "UP", "DOWN": "DOWN", "LEFT": "LEFT", "RIGHT": "RIGHT",
    "w": "UP", "s": "DOWN", "a": "LEFT", "d": "RIGHT",
}


def getch():
    """Read one key (decoding arrow escape sequences)."""
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        ch = sys.stdin.read(1)
        if ch == "\x1b":
            seq = sys.stdin.read(2)
            return {"[A": "UP", "[B": "DOWN", "[C": "RIGHT",
                    "[D": "LEFT"}.get(seq, "ESC")
        return ch
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


class GameLoop:
    """Terminal game loop over a level iterator."""

    def __init__(self, iterator, side_effect_weights=None, record_to=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.iterator = iterator
        self.side_effect_weights = side_effect_weights or {
            "life-green": 1.0, "spawner-yellow": 2.0}
        self.record_to = record_to
        self.edit_mode = False
        self.edit_goals = False
        self.undo_stack = []
        self.history = None
        self.message = "? for help"
        self.games = []
        self.game_idx = -1

    def next_level(self, delta=1):
        self.save_recording()
        self.game_idx += delta
        while self.game_idx >= len(self.games):
            lv = next(self.iterator)
            g = SafeLifeGame(board_size=None)
            g.deserialize(lv.copy())
            g.file_name = lv.name
            self.games.append(g)
        self.game_idx = max(self.game_idx, 0)
        self.game = self.games[self.game_idx]
        self.game.revert()
        self.undo_stack = []
        # History starts with the level's initial state so recordings
        # replay from the very beginning (parity:
        # interactive_game.py:155-165 record()-at-reset).
        self.history = {
            "board": [self.game.board.copy()],
            "goals": [self.game.goals.copy()],
            "agent_locs": [self.game.agent_locs.copy()],
        }
        self.scored = False

    def snapshot(self):
        self.undo_stack.append(
            (self.game.board.copy(), self.game.goals.copy(),
             self.game.agent_locs.copy(), self.game.num_steps))
        if len(self.undo_stack) > 10000:
            self.undo_stack.pop(0)

    def undo(self):
        if self.undo_stack:
            b, g, locs, steps = self.undo_stack.pop()
            self.game.board, self.game.goals = b, g
            self.game.agent_locs, self.game.num_steps = locs, steps
            self.game.game_over = False
            self.game._needs_new_counts = True

    def step_game(self, named_action):
        self.snapshot()
        if named_action != "WAIT":
            self.game.execute_action(named_action)
        self.game.advance_board()
        self.game.update_exit_colors()
        if self.history is not None:
            self.history["board"].append(self.game.board.copy())
            self.history["goals"].append(self.game.goals.copy())
            self.history["agent_locs"].append(self.game.agent_locs.copy())

    def shell_escape(self):
        """Drop into an interactive Python shell with the game in scope
        (parity: interactive_game.py:445-457)."""
        ns = {"game": self.game, "loop": self, "np": np}
        try:
            from IPython import embed
            embed(user_ns=ns)
        except ImportError:
            import code
            code.interact(banner="safelife_tpu_torch shell: game, loop, np",
                          local=ns)

    def log_human_benchmark(self, se, score):
        """Upload a finished human-played benchmark level to wandb when a
        run is active (parity: interactive_game.py:238-262)."""
        g = self.game
        name = str(getattr(g, "file_name", "") or "")
        if "-human" not in name:
            return
        try:
            import wandb
        except ImportError:
            return
        if wandb.run is None:
            return
        wandb.log({
            "level": name,
            "length": g.num_steps,
            "reward": float(np.sum(g.points_earned()[:1])),
            "side_effects": se.get("total", [0, 0])[0],
            "combined_score": score,
        })

    def save_recording(self):
        """Write the captured play history as ``rec-NNN.npz`` under
        ``record_to`` (parity: interactive_game.py:167-199)."""
        if not self.record_to or self.history is None \
                or len(self.history["board"]) < 2:
            return None
        import glob
        os.makedirs(self.record_to, exist_ok=True)
        old = glob.glob(os.path.join(self.record_to, "rec-*.npz"))
        n = 1 + max(
            (int(os.path.basename(f)[4:-4]) for f in old), default=0)
        path = os.path.join(self.record_to, "rec-%03d.npz" % n)
        np.savez_compressed(
            path,
            board=np.stack(self.history["board"]),
            goals=np.stack(self.history["goals"]),
            agent_locs=np.stack(self.history["agent_locs"]))
        self.message = "recorded %s" % path
        return path

    def end_of_level_summary(self):
        g = self.game
        fresh = SafeLifeGame(board_size=None)
        fresh.deserialize(g._init_data)
        init_board = np.asarray(fresh.board)
        se = side_effect_score(init_board, g.board, g.num_steps,
                               g.spawn_prob, num_samples=200, strkeys=True,
                               device=self.device)
        se["total"] = weighted_side_effect_total(
            se, self.side_effect_weights)
        reward = float(np.sum(g.points_earned()[:1]))
        possible = float(np.sum(g.initial_available_points()[:1])
                         + g.points_on_level_exit)
        _, score = combined_score({
            "reward": np.array([reward]),
            "reward_possible": np.array([possible]),
            "length": np.array([g.num_steps]),
            "side_effects": se})
        self.log_human_benchmark(se, float(score[0]))
        return se, float(score[0])

    def draw(self):
        os.system("clear")
        g = self.game
        mode = "EDIT %s" % ("GOALS" if self.edit_goals else "BOARD") \
            if self.edit_mode else "PLAY"
        print("SafeLife-TPU — %s — %s   steps: %d   points: %s" % (
            g.title or "level", mode, g.num_steps,
            np.round(g.points_earned(), 1).tolist()))
        board = g.board.copy()
        if self.edit_mode:
            print("cursor: %s  color: %s" % (
                g.edit_loc, g.edit_color_name))
        sys.stdout.write(render_board(
            g.goals if self.edit_goals and self.edit_mode else board,
            g.goals))
        print(self.message)
        self.message = ""

    def handle_play_key(self, key):
        if key in MOVE_KEYS:
            self.step_game("MOVE " + MOVE_KEYS[key])
        elif key in (" ", "\r", "\n"):
            self.step_game("TOGGLE")
        elif key == "c":
            self.step_game("WAIT")  # stand still, advance one step
        elif key == "z":
            self.undo()
        elif key == "r":
            self.game.revert()
            self.undo_stack = []
        elif key == "n":
            self.next_level(+1)
        elif key == "p":
            self.next_level(-1)

    def handle_edit_key(self, key):
        g = self.game
        prefix = "GOALS " if self.edit_goals else ""
        if key in MOVE_KEYS:
            g.execute_edit("MOVE " + MOVE_KEYS[key])
        elif key in EDIT_PALETTE:
            self.snapshot()
            g.execute_edit(prefix + "PUT " + EDIT_PALETTE[key])
        elif key == "[":
            self.message = g.execute_edit("PREVIOUS EDIT COLOR") or ""
        elif key == "]":
            self.message = g.execute_edit("NEXT EDIT COLOR") or ""
        elif key == "x":
            self.snapshot()
            g.execute_edit(prefix + "APPLY EDIT COLOR")
        elif key == "g":
            self.edit_goals = not self.edit_goals
        elif key == "s":
            name = g.file_name or "edited-level.npz"
            g.save(name if name.endswith(".npz") else name + ".npz")
            self.message = "saved %s" % g.file_name

    def run(self):
        self.next_level(+1)
        while True:
            if self.game.game_over and not self.edit_mode:
                if self.game.game_over is True and not self.scored:
                    self.scored = True
                    self.draw()
                    print("Level complete! computing side effects...")
                    se, score = self.end_of_level_summary()
                    self.message = "COMBINED SCORE: %.1f   (n=next level)" \
                        % score
                elif self.game.game_over in ("NEXT LEVEL",):
                    self.next_level(+1)
                elif self.game.game_over in ("PREV LEVEL",):
                    self.next_level(-1)
                elif self.game.game_over == "ABORT LEVEL":
                    return
            self.draw()
            key = getch()
            if key == "q" or key == "\x03":
                self.save_recording()
                return
            elif key == "?":
                self.message = HELP
            elif key == "\\":
                self.shell_escape()
            elif key == "e":
                self.edit_mode = not self.edit_mode
            elif self.edit_mode:
                self.handle_edit_key(key)
            else:
                self.handle_play_key(key)


def _expand_benchmark_paths(paths):
    """Expand ``benchmark-<name>`` to the packaged v1.2 human-benchmark
    archive (parity: interactive_game.py:909-913)."""
    import os

    from .io.levels import LEVEL_DIRECTORY

    out = []
    for p in paths:
        if p.startswith("benchmark-"):
            name = p[len("benchmark-"):] + "-human.npz"
            cand = os.path.join(LEVEL_DIRECTORY, "benchmarks", "v1.2", name)
            if os.path.exists(cand):
                p = cand
        out.append(p)
    return out


def play_cmd(args):
    """The ``play`` verb: the terminal (or, with ``--gl``, the pygame) game
    over ``args.paths``, its summaries on ``args.device``."""
    device = resolve_device(getattr(args, "device", "cuda"))
    it = SafeLifeLevelIterator(*_expand_benchmark_paths(args.paths),
                               seed=args.seed)
    if getattr(args, "gl", False):
        from .interactive_gl import GraphicalGameLoop
        GraphicalGameLoop(it, record_to=getattr(args, "record", None),
                          device=device).run()
    else:
        GameLoop(it, record_to=getattr(args, "record", None),
                 device=device).run()
