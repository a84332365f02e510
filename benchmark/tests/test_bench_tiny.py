"""A cell's tiny size and devices come from its files and its entry, never
from a table keyed by its name: the present cells keep theirs, a cell that
no file of tiny/ names gets its driver's default, and every file there
names a cell."""

import pytest

import tiny

PRESENT = {
    "offline_song": ({"files": {"count": 3, "min_s": 2, "max_s": 4}, "upmixer": {"chunk": 65536}, "warm_calls": 3},
                     ["cpu"]),
    "pool_2048": ({"streams": 8, "check": {"reservoir": 3}}, ["cpu"]),
    "pool_mesh4_8192": ({"streams": 16, "check": {"reservoir": 3, "streams": 8}}, ["cpu", "cpu:0", "cpu", "cpu:0"]),
    "offline_clips": ({"files": {"count": 400, "min_s": 0.5, "max_s": 2, "buffer_s": 5}, "check": {"reservoir": 4}},
                      ["cpu"]),
}


@pytest.mark.parametrize("workload", list(PRESENT))
def test_present_cells_keep_their_tiny_sizes(workload):
    assert (tiny.patch(workload), tiny.devices(workload)) == PRESENT[workload]


def test_a_new_cell_takes_its_drivers_default():
    bench = tiny.joined(tiny.spec(), tiny.NEW, tiny.LIKE)
    assert not (tiny.SIZES / f"{tiny.NEW}.json").exists()
    assert (tiny.patch(tiny.NEW, bench), tiny.devices(tiny.NEW, bench)) == PRESENT[tiny.LIKE]


def test_a_sequence_without_a_file_is_refused():
    bench = tiny.joined(tiny.spec(), "clips_again", "offline_clips")
    with pytest.raises(ValueError, match="clips_again.json"):
        tiny.patch("clips_again", bench)


def test_every_tiny_file_names_a_cell():
    files = {p.stem for p in tiny.SIZES.glob("*.json")}
    assert files and files <= set(tiny.cells())
