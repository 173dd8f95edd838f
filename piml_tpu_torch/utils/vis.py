"""Scene animation (reference: src/utils/visualization.py); counterpart of
``piml_tpu/utils/vis.py``.

matplotlib ``FuncAnimation`` player: pedestrians as circles colored by speed,
active routes, obstacle outline; plus the two-scene comparison overlay.
Host-side only, operating on the port's :class:`~piml_tpu_torch.scene.Scene`
(its tensors are read back to the host).  matplotlib is imported inside the
functions: a host without it can import this module.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from piml_tpu_torch.scene import Scene


def _actors(ax, scene: Scene, circle_kw=None, number_kw=None):
    import matplotlib.pyplot as plt

    circle_kw = circle_kw or {}
    number_kw = number_kw or {}
    actors = {}
    for ped in range(scene.num_pedestrians):
        actors[ped] = {
            "circle": plt.Circle((0, 0), **circle_kw, visible=False),
            "number": ax.text(0, 0, str(ped), **number_kw, size="xx-small",
                              visible=False, va="center", ha="center"),
            "route": ax.plot([], [], ls="-", marker=".",
                             color=(0.5, 0.5, 0.5, 0.1), visible=False)[0],
        }
        ax.add_patch(actors[ped]["circle"])
    actors["title"] = ax.set_title("")
    obstacles = scene.obstacles.cpu().numpy()
    if obstacles.size and not (obstacles >= 1e4).all():
        ax.plot(obstacles[:, 0], obstacles[:, 1], "-k")
    return actors


def _update(frame_num: int, scene: Scene, actors, show_speed=False,
            color: Optional[Callable] = None):
    pos = scene.position[frame_num].cpu().numpy()
    vel = scene.velocity[frame_num].cpu().numpy()
    mask = scene.mask_p[frame_num].cpu().numpy()
    wps = scene.waypoints.cpu().numpy()
    dest_idx = scene.dest_idx[frame_num].cpu().numpy()
    drawn = []
    for ped in range(scene.num_pedestrians):
        a = actors[ped]
        if mask[ped] == 0 or not np.isfinite(pos[ped]).all():
            a["circle"].set_visible(False)
            a["number"].set_visible(False)
            a["route"].set_visible(False)
            continue
        speed = float(np.linalg.norm(vel[ped]))
        c = color(frame_num) if color else (
            0, 1.34 / (1.34 + speed), speed / (1.34 + speed), 0.4
        )
        a["number"].set(position=tuple(pos[ped]), visible=True)
        a["circle"].set(center=tuple(pos[ped]), radius=0.19, color=c, visible=True)
        rest = wps[int(dest_idx[ped]):, ped, :]
        rest = rest[np.isfinite(rest).all(-1)]
        rt = np.concatenate([pos[ped][None], rest], axis=0)
        a["route"].set(data=(rt[:, 0], rt[:, 1]), visible=True)
        drawn += [a["circle"], a["number"], a["route"]]
    tu = scene.time_unit
    actors["title"].set_text(f"Frame {frame_num} / {frame_num * tu:.2f}s")
    drawn.append(actors["title"])
    return drawn


def _save_animation(ani, movie_file: str, writer):
    """Writer selection with graceful degradation: .mp4 needs ffmpeg (the
    reference assumes it, visualization.py:93; absent in this image) — fall
    back to an animated GIF next to the requested path; .html uses
    matplotlib's standalone HTML player (always available)."""
    import warnings

    import matplotlib.animation as animation

    if writer is None and movie_file.endswith(".html"):
        writer = animation.HTMLWriter(fps=12)
    if writer is None and movie_file.endswith(".mp4") \
            and not animation.writers.is_available("ffmpeg"):
        fallback = movie_file[:-4] + ".gif"
        warnings.warn(f"ffmpeg unavailable; writing {fallback} instead")
        movie_file = fallback
    ani.save(movie_file, writer=writer, dpi=200)
    return movie_file


def state_animation(ax, scene: Scene, *, movie_file: Optional[str] = None,
                    writer=None, show_speed: bool = False):
    """Animate one scene (reference: visualization.py:76-95)."""
    import matplotlib.animation as animation

    actors = _actors(ax, scene)
    ani = animation.FuncAnimation(
        ax.get_figure(), lambda i: _update(i, scene, actors, show_speed),
        frames=scene.num_steps, interval=scene.time_unit * 1000.0, blit=True,
    )
    if movie_file:
        # the actually-written path (may differ from movie_file: .mp4
        # degrades to .gif without ffmpeg) is exposed on the animation
        ani.saved_path = _save_animation(ani, movie_file, writer)
    return ani


def state_animation_compare(ax, scene1: Scene, scene2: Scene, *,
                            movie_file: Optional[str] = None, writer=None,
                            show_speed: bool = False):
    """Overlay comparison: scene1 colored, scene2 gray
    (reference: visualization.py:97-122)."""
    import matplotlib.animation as animation

    a1 = _actors(ax, scene1, {"zorder": 9}, {"zorder": 10})
    a2 = _actors(ax, scene2, {"zorder": 7}, {"zorder": 8, "alpha": 0.2})

    def update(i):
        return (_update(i, scene1, a1, show_speed)
                + _update(i, scene2, a2, show_speed,
                          color=lambda _: (0.2, 0.2, 0.2, 0.2)))

    ani = animation.FuncAnimation(
        ax.get_figure(), update, frames=scene2.num_steps,
        interval=scene2.time_unit * 1000.0, blit=True,
    )
    if movie_file:
        # the actually-written path (may differ from movie_file: .mp4
        # degrades to .gif without ffmpeg) is exposed on the animation
        ani.saved_path = _save_animation(ani, movie_file, writer)
    return ani
