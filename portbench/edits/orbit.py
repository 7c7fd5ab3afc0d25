"""``orbit``: a game frame every ``every_steps`` steps moves every sound
along the configuration's circle to its angle at that step's time.

A mix's keys under ``edits``: ``every_steps``, ``speed_rad_s`` [lo, hi]:
each sound's angular speed, drawn from the seed uniformly in [lo, hi].
The configuration's builder gives ``positions(cfg, angles)`` and
``move(scene, places)``; its inputs hold the starting ``angles``.
"""

import numpy as np


class Edits:
    def __init__(self, drv, params: dict, seed: int):
        self.drv = drv
        self.every = params["every_steps"]
        lo, hi = params["speed_rad_s"]
        self.speeds = np.random.default_rng([seed % 2**63, 7]).uniform(
            lo, hi, len(drv.inputs["angles"]))

    def places_at_step(self, step: int) -> np.ndarray:
        """f32[V, 3]: where the sounds are during ``step`` (the last game
        frame's places)."""
        drv = self.drv
        t = (step // self.every) * self.every * drv.step_frames / drv.sr
        return drv.cell.builder.positions(drv.cfg, drv.inputs["angles"] + self.speeds * t)

    def before_step(self, step: int) -> None:
        if step % self.every == 0:
            self.drv.cell.builder.move(self.drv.scene, self.places_at_step(step))

    def reference(self):
        """The quanta -> f32[V, Q, 3] places function the reference reads:
        the places the scene was given."""
        S = self.drv.superblock
        cache = {}

        def places(quanta):
            frames = []
            for q in np.asarray(quanta):
                g = (int(q) // S) // self.every
                if g not in cache:
                    cache[g] = self.places_at_step(g * self.every)
                frames.append(cache[g])
            return np.stack(frames, axis=1)

        return places
