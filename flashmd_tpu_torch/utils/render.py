"""Offline trajectory rendering with matplotlib (port of
flashmd_tpu/utils/render.py; the reference's scripts/render_readme_gif.py).

Reads the ``<filename>_coords_<NNNN>.npy`` rotation that the simulation
engine writes (simulation/base.py), axes (n_sims, frames, atoms, 3), and
draws one frame to a PNG or one trajectory to an animated GIF. Only the
drawing functions import matplotlib: ``load_coords`` needs numpy alone.

Usage:
    flashmd-torch-render out/demo --sim 0 --stride 2 --gif traj.gif
    flashmd-torch-render out/demo --png frame.png --frame -1
"""

from __future__ import annotations

import argparse
import glob
from typing import Optional, Sequence

import numpy as np


def load_coords(prefix: str) -> np.ndarray:
    """Concatenate every ``<prefix>_coords_<NNNN>.npy`` along frames.

    Returns [n_sims, total_frames, atoms, 3].
    """
    files = sorted(glob.glob(f"{prefix}_coords_[0-9]*.npy"))
    if not files:
        raise FileNotFoundError(f"no '{prefix}_coords_*.npy' files found")
    chunks = [np.load(f) for f in files]
    return np.concatenate(chunks, axis=1)


def _setup_axes(coords_sim: np.ndarray):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6), dpi=110)
    ax = fig.add_subplot(projection="3d")
    ax.set_axis_off()
    lo = coords_sim.reshape(-1, 3).min(axis=0)
    hi = coords_sim.reshape(-1, 3).max(axis=0)
    center = (lo + hi) / 2
    half = float((hi - lo).max()) / 2 or 1.0
    ax.set_xlim(center[0] - half, center[0] + half)
    ax.set_ylim(center[1] - half, center[1] + half)
    ax.set_zlim(center[2] - half, center[2] + half)
    return fig, ax


def _draw_frame(ax, frame: np.ndarray, bonds: Optional[np.ndarray]):
    """One frame: a chain/bond trace plus atom markers, colored by index."""
    n = frame.shape[0]
    if bonds is None:
        # coarse-grained proteins are chains: connect consecutive beads
        bonds = np.stack([np.arange(n - 1), np.arange(1, n)])
    segs = frame[np.asarray(bonds).T]  # [n_bonds, 2, 3]
    from mpl_toolkits.mplot3d.art3d import Line3DCollection

    lines = Line3DCollection(segs, colors="#5577aa", linewidths=1.2)
    ax.add_collection3d(lines)
    ax.scatter(
        frame[:, 0], frame[:, 1], frame[:, 2],
        c=np.arange(n), cmap="viridis", s=14, depthshade=False,
    )


def render_png(
    coords: np.ndarray,
    out: str,
    sim: int = 0,
    frame: int = -1,
    bonds: Optional[np.ndarray] = None,
) -> str:
    """Render one frame of one trajectory to a PNG. Returns ``out``."""
    sim_coords = coords[sim]
    fig, ax = _setup_axes(sim_coords)
    _draw_frame(ax, sim_coords[frame], bonds)
    fig.savefig(out, bbox_inches="tight")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return out


def render_gif(
    coords: np.ndarray,
    out: str,
    sim: int = 0,
    stride: int = 1,
    fps: int = 12,
    rotate: bool = True,
    bonds: Optional[np.ndarray] = None,
) -> str:
    """Render one trajectory to an animated GIF. Returns ``out``."""
    from matplotlib import animation

    sim_coords = coords[sim, ::stride]
    fig, ax = _setup_axes(sim_coords)
    n_frames = sim_coords.shape[0]

    def update(i):
        for artist in list(ax.collections):
            artist.remove()
        _draw_frame(ax, sim_coords[i], bonds)
        if rotate:
            ax.view_init(elev=20, azim=(i * 360.0 / max(n_frames, 1)) % 360)
        return ax.collections

    anim = animation.FuncAnimation(
        fig, update, frames=n_frames, interval=1000 // fps
    )
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    import matplotlib.pyplot as plt

    plt.close(fig)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Render saved flashmd_tpu_torch trajectories "
        "(<prefix>_coords_<NNNN>.npy) to GIF/PNG."
    )
    parser.add_argument(
        "prefix", help="output prefix, e.g. out/demo for out/demo_coords_*"
    )
    parser.add_argument("--sim", type=int, default=0, help="trajectory index")
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--fps", type=int, default=12)
    parser.add_argument("--no-rotate", action="store_true")
    parser.add_argument("--gif", default=None, help="write animated GIF here")
    parser.add_argument("--png", default=None, help="write a single PNG here")
    parser.add_argument(
        "--frame", type=int, default=-1, help="frame for --png (default last)"
    )
    args = parser.parse_args(argv)
    if not args.gif and not args.png:
        parser.error("pass --gif PATH and/or --png PATH")

    coords = load_coords(args.prefix)
    if not 0 <= args.sim < coords.shape[0]:
        parser.error(
            f"--sim {args.sim} out of range (n_sims={coords.shape[0]})"
        )
    if args.png:
        print(render_png(coords, args.png, sim=args.sim, frame=args.frame))
    if args.gif:
        print(
            render_gif(
                coords, args.gif, sim=args.sim, stride=args.stride,
                fps=args.fps, rotate=not args.no_rotate,
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
