"""Tiny fixture cells for the CPU tests: their traffic and limits."""

TRAIN = {"kind": "train", "batch_size": 4, "check_steps": 3,
         "trace_steps": 2}
SERVE_CLOSED = {"kind": "serve", "loop": "closed", "clients": 4,
                "max_batch": 2, "max_delay_ms": 5.0, "max_pending": 64,
                "pool": 6, "warm_buckets": [1, 2], "settle_s": 0.3,
                "trace_s": 0.3, "check_requests": 12}
SERVE_OPEN = dict(SERVE_CLOSED, loop="open", rate_per_s=40.0, gap_count=64,
                  schedule_seed=1)
# Limits at the tiny size (bf16), above what clean runs read on the CPU
# (batch 3e-5, loss 1.4e-4, grad 3.8e-4, change 0.08; waves 2e-3, masks
# 9e-4) and below what the planted faults read.
TRAIN_LIMITS = {"batch_rel": 1e-3, "loss_gap": 5e-3, "grad_gap": 1e-2,
                "change_gap": 0.5}
SERVE_LIMITS = {"wave_rel": 0.05, "mask_abs": 0.01}

CELLS = {"tiny.train_b128": (TRAIN, TRAIN_LIMITS),
         "tiny.serve_closed64": (SERVE_CLOSED, SERVE_LIMITS),
         "tiny.serve_open": (SERVE_OPEN, SERVE_LIMITS)}

# The serving cells' metrics, as BENCHMARK.json would list them with the
# serving cells (not in it yet: see PERF.md, Open questions).
SERVE_METRICS = {
    "end_to_end": [
        {"name": "serve_audio_s_per_s", "unit": "audio-s/s",
         "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": ["tiny.serve_closed64"]},
        {"name": "serve_latency_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["tiny.serve_open"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": src, "layer": layer,
         "moves": moves, "workloads": [w]}
        for w, moves, suffix in (
            ("tiny.serve_closed64", "serve_audio_s_per_s", "closed"),
            ("tiny.serve_open", "serve_latency_p95_ms", "open"))
        for n, u, b, src, layer in (
            (f"device.idle_pct.{suffix}", "%", "lower", "device_trace",
             "device"),
            (f"sched.mean_batch.{suffix}", "requests/batch", "higher",
             "program_counter", "scheduler"),
            (f"separator.copy_ms_per_batch.{suffix}", "ms", "lower",
             "device_trace", "separator"))]
    + [{"name": "device.mfu.serve", "unit": "%", "better": "higher",
        "source": "host_clock", "layer": "device",
        "moves": "serve_audio_s_per_s", "workloads": ["tiny.serve_closed64"]},
       {"name": "client.lateness_p95_ms.open", "unit": "ms",
        "better": "lower", "source": "host_clock", "layer": "load generator",
        "moves": "serve_latency_p95_ms", "workloads": ["tiny.serve_open"]}]}
