"""Record the MoE layers' routes, and count the routings that flip between
one forward and step-by-step decode.

``routes_recorded`` wraps ``layers.moe_route``, which ``moe_mlp`` looks up
at each call; ``routing_flips`` compares the chosen experts of a forward
with those of the decode steps over the same positions. Imports nothing
but torch, so the card tests (``tests/test_torch_cuda.py``) use it too.
"""
import contextlib

import torch


@contextlib.contextmanager
def routes_recorded(L):
    """Every ``MoeRoute`` that ``layers.moe_route`` returns while open, in
    call order (``moe_mlp`` looks the helper up at each call)."""
    routes, route = [], L.moe_route

    def recorded(*args):
        r = route(*args)
        routes.append(r)
        return r

    L.moe_route = recorded
    try:
        yield routes
    finally:
        L.moe_route = route


def routing_flips(experts, S: int) -> torch.Tensor:
    """(layer, B, S) bool: the (token, layer) routings whose set of chosen
    experts differs between one forward over S positions and S decode
    steps. ``experts`` holds each MoE layer call's chosen experts (B, n, k)
    in call order: the forward's layers (n = S), then each step's (n = 1)."""
    n = len(experts) // (S + 1)
    assert n and len(experts) == n * (S + 1), (len(experts), S)
    chosen = [torch.as_tensor(e).sort(dim=-1).values for e in experts]
    B, k = chosen[0].shape[0], chosen[0].shape[-1]
    fwd = torch.stack(chosen[:n])
    step = torch.cat(chosen[n:], dim=1).reshape(B, S, n, k).permute(2, 0, 1, 3)
    return (fwd != step).any(dim=-1)
