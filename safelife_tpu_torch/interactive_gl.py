"""The graphical front end of the interactive game: a pygame window.

Port of ``safelife_tpu/interactive_gl.py:1-149``: ``GraphicalGameLoop``,
the play/edit key handling of :class:`.interactive.GameLoop` (shared) in a
window that shows the sprite frames of :mod:`.render.graphics` (role of the
reference's pyglet front end, ``interactive_game.py:664-828``). ``pygame``
is imported only by the methods that use it.

Run headless (tests, CI) with ``SDL_VIDEODRIVER=dummy``.
"""

import numpy as np

from .interactive import HELP, GameLoop

#: Window pixels per sprite pixel (sprites are 14px per cell).
SCALE = 2
#: Height of the status strip under the board, in window pixels.
STATUS_H = 54


class GraphicalGameLoop(GameLoop):
    """Windowed game loop; game/edit logic inherited from GameLoop."""

    def __init__(self, *args, fps=30, **kwargs):
        super().__init__(*args, **kwargs)
        self.fps = fps
        self._screen = None
        self._font = None

    # -- keyboard ------------------------------------------------------

    def _translate(self, event):
        """Map a pygame KEYDOWN to the GameLoop key vocabulary."""
        import pygame

        arrows = {pygame.K_UP: "UP", pygame.K_DOWN: "DOWN",
                  pygame.K_LEFT: "LEFT", pygame.K_RIGHT: "RIGHT"}
        if event.key in arrows:
            return arrows[event.key]
        if event.key in (pygame.K_RETURN, pygame.K_KP_ENTER):
            return "\r"
        ch = event.unicode
        return ch if ch else None

    def dispatch_key(self, key):
        """Shared key dispatch; returns False when the game should quit."""
        if key in ("q", "\x03"):
            self.save_recording()
            return False
        if key == "?":
            self.message = HELP
        elif key == "e":
            self.edit_mode = not self.edit_mode
        elif key == "\\":
            self.shell_escape()
        elif self.edit_mode:
            self.handle_edit_key(key)
        else:
            self.handle_play_key(key)
        return True

    # -- drawing -------------------------------------------------------

    def _frame(self):
        from .render.graphics import render_board

        g = self.game
        show = g.goals if self.edit_goals and self.edit_mode else g.board
        return render_board(show, g.goals)

    def draw_window(self):
        import pygame

        rgb = self._frame()
        h, w = rgb.shape[:2]
        size = (w * SCALE, h * SCALE + STATUS_H)
        if self._screen is None or self._screen.get_size() != size:
            self._screen = pygame.display.set_mode(size)
            pygame.display.set_caption("SafeLife-TPU")
        surf = pygame.surfarray.make_surface(rgb.swapaxes(0, 1))
        surf = pygame.transform.scale(surf, (w * SCALE, h * SCALE))
        self._screen.fill((16, 16, 16))
        self._screen.blit(surf, (0, 0))

        if self._font is None:
            pygame.font.init()
            self._font = pygame.font.Font(None, 20)
        g = self.game
        mode = ("EDIT " + ("GOALS" if self.edit_goals else "BOARD")
                if self.edit_mode else "PLAY")
        lines = [
            "%s - %s   steps: %d   points: %s" % (
                g.title or "level", mode, g.num_steps,
                np.round(g.points_earned(), 1).tolist()),
            (self.message or "? for help").splitlines()[0],
        ]
        for i, text in enumerate(lines):
            img = self._font.render(text, True, (230, 230, 230))
            self._screen.blit(img, (6, h * SCALE + 6 + 22 * i))
        pygame.display.flip()

    # -- loop ----------------------------------------------------------

    def check_level_transition(self):
        """End-of-level bookkeeping shared with the terminal loop."""
        if not self.game.game_over or self.edit_mode:
            return True
        if self.game.game_over is True and not self.scored:
            self.scored = True
            se, score = self.end_of_level_summary()
            self.message = "COMBINED SCORE: %.1f   (n=next level)" % score
        elif self.game.game_over == "NEXT LEVEL":
            self.next_level(+1)
        elif self.game.game_over == "PREV LEVEL":
            self.next_level(-1)
        elif self.game.game_over == "ABORT LEVEL":
            return False
        return True

    def run(self, max_frames=None):
        """The window loop. ``max_frames`` bounds the loop for tests."""
        import pygame

        pygame.init()
        self.next_level(+1)
        clock = pygame.time.Clock()
        frames = 0
        running = True
        while running and (max_frames is None or frames < max_frames):
            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    self.save_recording()
                    running = False
                elif event.type == pygame.KEYDOWN:
                    # A message (score, help) stays on screen until the
                    # next keypress, like the terminal frontend.
                    self.message = ""
                    key = self._translate(event)
                    if key is not None and not self.dispatch_key(key):
                        running = False
            if running:
                running = self.check_level_transition()
            self.draw_window()
            clock.tick(self.fps)
            frames += 1
        pygame.quit()
