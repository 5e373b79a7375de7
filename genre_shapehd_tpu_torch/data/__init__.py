"""Host-side data: PNG I/O, test-time preprocessing, the glob test
dataset, the synthetic and procedural datasets and the batched loader."""
