"""Input pipelines: decode, transforms, loaders, webdataset shards."""
