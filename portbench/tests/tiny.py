"""The cells at sizes a CPU test run holds (key overrides of the cells'
files)."""
TINY = {
    "cornell-train": {
        "config": {"camera": {"image_width": 24}},
        "traffic": {"lanes": 512, "spp": 4,
                    "trace_steps": 1},
        "cell": {"n_iters": 12},
    },
    "demo1-fwd": {
        "config": {"camera": {"image_width": 32}, "render": {"max_depth": 12}},
        "traffic": {"pass_spp": 4, "warm_spp": 2},
        "cell": {"check_pixels": 64},
    },
}
SEED = 2 ** 31 + 12345
