-- MySQL overlay of the relation-tuple table (reference migration
-- 20210623162417000000_relationtuple.mysql.up.sql): AUTO_INCREMENT
-- sequence, VARCHAR key columns (TEXT cannot be indexed without prefix
-- lengths), no partial indexes (MySQL has none — plain composite indexes
-- with subject columns leading the NULL-filterable tail).
CREATE TABLE keto_relation_tuples (
    seq BIGINT AUTO_INCREMENT PRIMARY KEY,
    shard_id VARCHAR(64) NOT NULL,
    nid VARCHAR(64) NOT NULL,
    namespace VARCHAR(191) NOT NULL,
    object VARCHAR(191) NOT NULL,
    relation VARCHAR(191) NOT NULL,
    subject_id VARCHAR(191),
    subject_set_namespace VARCHAR(191),
    subject_set_object VARCHAR(191),
    subject_set_relation VARCHAR(191),
    commit_time DOUBLE NOT NULL,
    CHECK ((subject_id IS NULL) <> (subject_set_namespace IS NULL)),
    CHECK ((subject_set_namespace IS NULL) = (subject_set_object IS NULL)
       AND (subject_set_object IS NULL) = (subject_set_relation IS NULL))
);

-- Dedup index. The subject columns are nullable (exactly one side of the
-- subject union is set per row), and MySQL unique indexes treat NULL as
-- distinct from NULL -- a raw-column index here never rejects a duplicate
-- tuple, because every row carries NULLs on one side. Wrap each nullable
-- column in a functional key part (MySQL 8.0.13+; note the doubled parens)
-- that coalesces NULL to '' so two identical tuples collide. '' never
-- aliases a real value: validation rejects empty subject fields.
CREATE UNIQUE INDEX keto_relation_tuples_uq
    ON keto_relation_tuples (nid, namespace, object, relation,
        (coalesce(subject_id, '')),
        (coalesce(subject_set_namespace, '')),
        (coalesce(subject_set_object, '')),
        (coalesce(subject_set_relation, '')));

CREATE INDEX keto_relation_tuples_subject_id_idx
    ON keto_relation_tuples (nid, namespace, object, relation, subject_id);
CREATE INDEX keto_relation_tuples_subject_set_idx
    ON keto_relation_tuples (nid, namespace, object, relation,
        subject_set_namespace, subject_set_object, subject_set_relation);
