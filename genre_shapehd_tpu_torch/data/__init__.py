"""Host-side data: PNG I/O, test-time preprocessing, the glob test
dataset and the batched loader."""
