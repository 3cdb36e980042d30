"""Host input and output of the port: FASTA/FASTQ, M4/PAF, filter files."""
