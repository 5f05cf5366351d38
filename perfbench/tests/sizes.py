"""Each cell's sizes for the tests, found by the cell's name in
``tiny/<cell>.json`` beside this file: the parameters that override the
workload's (and, under ``config``, the configuration's) so that the CPU
runs a whole cell in seconds, the widths staying the published ones. Under
``card`` a file may hold the sizes at which the card's tests run the cell.
A cell brings its file with it, and no test lists cells of its own."""

import os

from perfbench import harness

TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny")

#: A seed above 32 signed bits: runs take any whole number that large.
SEED = 2 ** 31 + 104729


def path(cell):
    return os.path.join(TINY, cell + ".json")


def tiny(cell):
    """The sizes at which the CPU tests run ``cell`` (raises when the cell
    has no file)."""
    sizes = harness.load_json(path(cell))
    sizes.pop("card", None)
    return sizes


def card(cell):
    """The sizes at which the card's tests run ``cell``, or None where its
    file has none (or it has no file: the CPU tests fail that cell)."""
    if not os.path.exists(path(cell)):
        return None
    return harness.load_json(path(cell)).get("card")
