from .reads import (make_reference, simulate_reads, simulate_pairs,  # noqa: F401
                    simulate_reference, simulate_reads_multi,
                    simulate_pairs_multi, encode, decode, revcomp_read,
                    write_fasta, write_fastq, write_fastq_pair)
