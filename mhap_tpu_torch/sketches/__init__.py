"""Secondary sketch family of the port: bit sketches (kernel 6 compares
them on the card), their LSH index, cosine sketch and counters."""
