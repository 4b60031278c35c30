-- Per-network monotonic write counter: the durable snaptoken source (the
-- device snapshot layer keys residency off it; the reference never
-- implemented snaptokens, SURVEY.md §5).
CREATE TABLE keto_store_version (
    nid TEXT PRIMARY KEY,
    version INTEGER NOT NULL
);
