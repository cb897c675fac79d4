"""The trace reader on a hand-made Chrome trace."""

from pytest import approx

from graphbench import trace


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    # two calls: [0, 100] and [100, 200]; the program inside each
    ev("user_annotation", trace.CALL, 0, 100),
    ev("user_annotation", trace.PROGRAM, 0, 80),
    ev("user_annotation", trace.CALL, 100, 100),
    ev("user_annotation", trace.PROGRAM, 100, 90),
    # host: a sync inside each program, one after it (the harness's own)
    ev("cuda_runtime", "cudaStreamSynchronize", 30, 20),
    ev("cuda_runtime", "cudaMemcpyAsync", 35, 1),
    ev("cuda_runtime", "cudaStreamSynchronize", 150, 10),
    ev("cuda_runtime", "cudaDeviceSynchronize", 85, 10),
    ev("cpu_op", "aten::item", 25, 30),
    # device: overlapping kernels [10, 30] + [20, 40], a copy [120, 170]
    ev("kernel", "k_a", 10, 20),
    ev("kernel", "k_b", 20, 20),
    ev("gpu_memcpy", "Memcpy DtoH", 120, 50),
    # outside the window: ignored
    ev("kernel", "k_late", 300, 50),
]


def test_busy_window_and_calls():
    s = trace.summarize(EVENTS)
    assert s.window_s == approx(200e-6)
    assert s.busy_s == approx(80e-6)
    assert s.call_busy_s == approx([30e-6, 50e-6])
    assert s.calls == 2


def test_syncs_count_only_inside_the_program():
    s = trace.summarize(EVENTS)
    # the two stream syncs; the device sync at 85 is after the program
    assert s.syncs == 2 and s.syncs_per_call == 1.0


def test_breakdown_orders_by_time():
    s = trace.summarize(EVENTS)
    assert [n for n, _ in s.device_ops] == ["Memcpy DtoH", "k_a", "k_b"]
    assert [v for _, v in s.device_ops] == approx([50e-6, 20e-6, 20e-6])
    # idle [0, 10], [40, 120] and [170, 200]: the innermost host event
    # open at each middle is the program's range (the syncs are over)
    assert s.idle_gaps == [[trace.PROGRAM, approx(120e-6)]]
