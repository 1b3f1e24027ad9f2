"""Rank placement of ``parallel/mesh.py::make_mesh`` on the cards: rank r
runs on ``cuda:LOCAL_RANK``, and a rank whose ``LOCAL_RANK`` names no
visible card raises before it touches the card or the process group (it
never falls back to another card, to gloo or to the CPU). On the CPU, with
``torch.cuda`` standing for a host of two cards."""

import pytest
import torch
import torch.distributed as dist

from radar_depth_tpu_torch.parallel import mesh as pm


@pytest.fixture
def two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    return picked


@pytest.mark.parametrize("local", [2, 3])
def test_a_rank_without_a_card_of_its_own_raises(monkeypatch, two_cards,
                                                  local):
    monkeypatch.setenv("RANK", str(local))
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", str(local))
    with pytest.raises(RuntimeError, match="no card of its own"):
        pm.make_mesh()
    assert two_cards == []  # no card was selected
