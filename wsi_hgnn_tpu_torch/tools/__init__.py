"""Command-line tools of the port (run as `python -m
wsi_hgnn_tpu_torch.tools.<name>`): `serve` (HTTP serving with
micro-batching), `pretrain_simclr` (SimCLR pretraining and feature
extraction), `vis_graphcam` (GTN GraphCAM maps), `process_remix_dataset`
(the ReMix bag layout), `convert_reference_checkpoint` and
`convert_reference_graphs` (a reference user's trained model and DGL
graphs into the formats both packages read)."""
