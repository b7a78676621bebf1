"""Mean, over the traced jobs, of the summed job layer spans of a job's
trace: job_open (open the source, check its length, mark the job
running), encoder_build (build the encoder, plan the GOPs), stitch,
mux and commit (write, rename, complete)."""

from tvbench.hostpath import job_spans_ms

#: the job layer's spans in the program's job trace
NAMES = ("job_open", "encoder_build", "stitch", "mux", "commit")


def read(rec):
    return job_spans_ms(rec, NAMES)
