"""Data in the port: the fixed tokenizer, the synthetic bigram corpus and
the user-sharded federated dataset (numpy, as in the reference, so one seed
gives both packages the same users and batches)."""
