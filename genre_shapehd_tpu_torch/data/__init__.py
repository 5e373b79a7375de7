"""Host-side data: PNG I/O, test-time preprocessing, the glob test
dataset, the synthetic, procedural and ShapeNet datasets and the batched
loader."""
