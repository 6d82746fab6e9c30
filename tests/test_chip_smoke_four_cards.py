"""chip_smoke.py --four-cards, rehearsed on four virtual CPU devices.

The parent stays off JAX; children run the CLI: one child on one device,
one child with a mesh over four, and four ``--distributed`` children with
one device each, compared as on the cards.
"""
import os

import chip_smoke

from .test_chip_smoke import TINY_CASE


def test_four_cards_on_virtual_devices(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def env(card):
        e = dict(os.environ)
        e["PYTHONPATH"] = repo
        e["JAX_PLATFORMS"] = "cpu"
        e["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                          f"{4 if card is None else 1}")
        return e

    dev = chip_smoke.four_cards(str(tmp_path), case=TINY_CASE,
                                child_env=env, expect_platform="cpu",
                                timeout=600)
    assert dev == {"platform": "cpu", "kind": "cpu", "count": 4}
