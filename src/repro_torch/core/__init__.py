"""Pipeline stages of the port: FM-index, SMEM, SAL, chaining, BSW, SAM."""
