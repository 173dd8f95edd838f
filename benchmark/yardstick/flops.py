"""Model FLOPs of the PINNSF mathematics: 2·in·out for each linear layer,
times the rows it sees.  Per-edge layers see each live agent's k1 (agent
branch) or k2 (obstacle branch) edges, node layers each live agent.  A
training step counts three times its forward; recomputation under
checkpointing is not counted."""

from __future__ import annotations

from benchmark.yardstick.model_layers import layers


def per_agent_frame(widths: dict, k1: int, k2: int) -> int:
    """FLOPs of one live agent in one frame's forward."""
    edges = {"ped": k1, "obs": k2, "node": 1}
    return sum(2 * i * o * edges[rows] for _, i, o, rows in layers(widths))


def forward(widths: dict, k1: int, k2: int, live_agent_frames: float) -> float:
    return per_agent_frame(widths, k1, k2) * float(live_agent_frames)


def train_step(widths: dict, k1: int, k2: int,
               live_agent_frames: float) -> float:
    return 3.0 * forward(widths, k1, k2, live_agent_frames)
