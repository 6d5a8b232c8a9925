"""FASTA/FASTQ ingestion, the on-disk index bundle and read batching
(copies of ``repro.io``; the bundle format is shared, so an index written
by either package loads in the other)."""
