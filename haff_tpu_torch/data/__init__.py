"""Host-side data preparation of the port: tokenizer, prompts, collate,
transforms, the datasets and the prefetching loader."""
