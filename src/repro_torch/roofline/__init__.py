"""The dry run's counters and roofline: per-rank op counts of a step on
fake tensors (``op_count``) priced at the H100's rates (``analysis``)."""
