"""File formats: the Parquet and ORC readers and writers and the record
decoders. Readers produce Batches on the caller's device."""
