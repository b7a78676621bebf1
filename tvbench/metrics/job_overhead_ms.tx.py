"""Mean, over the traced jobs, of a job's wall time on the benchmark's
clock (add_job to its return) minus the extent of its wave pipeline (the
first wave's staging, its first decode or stage span, to the last
wave_collect span's end, from the job's obs.trace spans): open, encoder
construction, stitch, mux and the coordinator. The first wave's decode
and staging count in ingest_ms_per_frame.tx, not here."""

#: the spans that start a job's wave pipeline: the staging of its first
#: wave (decode, stage) and, should the staging record none, its first
#: dispatch
_START = ("decode", "stage", "wave_dispatch")


def read(rec):
    out = []
    for job in rec.get("jobs", []):
        spans = job.get("spans")
        if not spans or not job["ok"]:
            continue
        starts = [s for n, s, _ in spans if n in _START]
        ends = [e for n, _, e in spans if n == "wave_collect"]
        if not starts or not ends:
            continue
        out.append((job["t1"] - job["t0"]) - (max(ends) - min(starts)))
    return 1e3 * sum(out) / len(out) if out else None
